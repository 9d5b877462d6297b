"""The tokenizer's C++ BPE merge core (`bpe_core.cc`), built with g++ and bound by ctypes.

The port's counterpart of feed_forward_vqgan_clip_tpu/native/__init__.py. At
first use the source is compiled with the system g++

    g++ -O3 -std=c++17 -shared -fPIC bpe_core.cc -o libbpe_core_<source hash>.so

into `build/ffvc_torch_kernels/` beside the package (where the CUDA kernels
go, listed in .gitignore); an unchanged source loads the library already
there. A failed build (no compiler) is logged once at WARNING and `get_lib()`
returns None: the tokenizer then runs its pure-Python merge loop, and says so
(`ClipTokenizer.native is None`). FFVC_DISABLE_NATIVE=1 skips the core.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from feed_forward_vqgan_clip_tpu_torch.ops.kernels.build import BUILD_DIR

log = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "bpe_core.cc"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[Path]:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libbpe_core_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(lib.name + f".build{os.getpid()}")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        log.warning("native BPE core not built (%s %s); the tokenizer runs its pure-Python "
                    "merge loop", e, detail.decode(errors="replace").strip())
        return None
    os.replace(tmp, lib)
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The bound library, built on the first call; None where it cannot be."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("FFVC_DISABLE_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.bpe_table_new.argtypes = [i32p, i32p, i32p, i32p, ctypes.c_int32]
    lib.bpe_table_new.restype = ctypes.c_void_p
    lib.bpe_table_free.argtypes = [ctypes.c_void_p]
    lib.bpe_apply_batch.argtypes = [ctypes.c_void_p, i32p, i32p, ctypes.c_int32, i32p, i32p,
                                    ctypes.c_int32]
    lib.bpe_apply_batch.restype = ctypes.c_int32
    _LIB = lib
    return _LIB


class NativeBPE:
    """A merge table in the C++ core. Symbols are the encoder's vocabulary ids."""

    def __init__(self, merges_by_id, lib: ctypes.CDLL):
        """merges_by_id: (left id, right id, rank, result id) per merge."""
        self._lib = lib
        arr = np.asarray(merges_by_id, np.int32).reshape(-1, 4)
        cols = [np.ascontiguousarray(arr[:, j]) for j in range(4)]
        self._table = lib.bpe_table_new(*cols, len(arr))

    def apply_batch(self, words: Sequence[Sequence[int]]) -> List[List[int]]:
        """Symbol-id lists -> merged-id lists, in one call."""
        if not words:
            return []
        offsets = np.zeros(len(words) + 1, np.int32)
        np.cumsum([len(w) for w in words], out=offsets[1:])
        syms = np.fromiter((s for w in words for s in w), np.int32, count=int(offsets[-1]))
        out = np.empty(int(offsets[-1]), np.int32)  # merges never grow a word
        out_offsets = np.empty(len(words) + 1, np.int32)
        n = self._lib.bpe_apply_batch(self._table, syms, offsets, len(words), out, out_offsets,
                                      len(out))
        if n < 0:
            raise RuntimeError("BPE output overflow")
        return [out[out_offsets[i]:out_offsets[i + 1]].tolist() for i in range(len(words))]

    def __del__(self):
        if getattr(self, "_table", None):
            self._lib.bpe_table_free(self._table)
