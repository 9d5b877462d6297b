// Native BPE merge kernel.
//
// The port's copy of feed_forward_vqgan_clip_tpu/native/bpe_core.cc. The
// byte-pair-merge loop is the host-side hot path when tokenizing caption
// corpora (`tokenize`, the encoders). This core applies merges over integer
// symbol ids: Python owns the vocabulary and hands over the merge table once;
// a batch of words is then a single FFI call.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC bpe_core.cc -o libbpe_core_<hash>.so
// (native/__init__.py, at first use)

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

using std::size_t;

namespace {

struct MergeInfo {
  int32_t rank;
  int32_t result;
};

struct MergeTable {
  std::unordered_map<uint64_t, MergeInfo> merges;
};

inline uint64_t pack(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

}  // namespace

extern "C" {

MergeTable* bpe_table_new(const int32_t* lefts, const int32_t* rights,
                          const int32_t* ranks, const int32_t* results,
                          int32_t n) {
  auto* t = new MergeTable();
  t->merges.reserve(static_cast<size_t>(n) * 2);
  for (int32_t i = 0; i < n; ++i) {
    t->merges.emplace(pack(lefts[i], rights[i]), MergeInfo{ranks[i], results[i]});
  }
  return t;
}

void bpe_table_free(MergeTable* t) { delete t; }

// Apply merges to `syms[0..n)` until no applicable pair remains; write the
// result into `out` (capacity `max_out`). Returns the output length, or -1 on
// overflow. Matches the reference algorithm: repeatedly merge the
// lowest-ranked pair, scanning left to right (first occurrence wins within a
// round, and a merged symbol can immediately pair with the following one).
int32_t bpe_apply(const MergeTable* t, const int32_t* syms, int32_t n,
                  int32_t* out, int32_t max_out) {
  std::vector<int32_t> word(syms, syms + n);
  std::vector<int32_t> next;
  next.reserve(n);

  while (word.size() >= 2) {
    // find the lowest-ranked adjacent pair
    int32_t best_rank = INT32_MAX;
    int32_t best_left = -1, best_right = -1, best_result = -1;
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      auto it = t->merges.find(pack(word[i], word[i + 1]));
      if (it != t->merges.end() && it->second.rank < best_rank) {
        best_rank = it->second.rank;
        best_left = word[i];
        best_right = word[i + 1];
        best_result = it->second.result;
      }
    }
    if (best_left < 0) break;

    // merge every (best_left, best_right) occurrence left to right
    next.clear();
    for (size_t i = 0; i < word.size();) {
      if (i + 1 < word.size() && word[i] == best_left &&
          word[i + 1] == best_right) {
        next.push_back(best_result);
        i += 2;
      } else {
        next.push_back(word[i]);
        i += 1;
      }
    }
    word.swap(next);
  }

  if (static_cast<int32_t>(word.size()) > max_out) return -1;
  for (size_t i = 0; i < word.size(); ++i) out[i] = word[i];
  return static_cast<int32_t>(word.size());
}

// Batch variant: apply merges to many words in one call. `syms` holds all
// words back to back; `offsets[i]..offsets[i+1]` delimits word i (n_words+1
// entries). Results are written back to back into `out` with output offsets in
// `out_offsets` (n_words+1). Returns total output length, or -1 on overflow.
int32_t bpe_apply_batch(const MergeTable* t, const int32_t* syms,
                        const int32_t* offsets, int32_t n_words, int32_t* out,
                        int32_t* out_offsets, int32_t max_out) {
  int32_t pos = 0;
  out_offsets[0] = 0;
  for (int32_t w = 0; w < n_words; ++w) {
    int32_t n = offsets[w + 1] - offsets[w];
    int32_t written =
        bpe_apply(t, syms + offsets[w], n, out + pos, max_out - pos);
    if (written < 0) return -1;
    pos += written;
    out_offsets[w + 1] = pos;
  }
  return pos;
}

}  // extern "C"
