"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o <stem>.o csrc/<stem>.cu          (one per source)
    nvcc ... -shared -o libffvc_<hash>.so *.o

into `build/ffvc_torch_kernels/` beside the package (listed in .gitignore). The
file name carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads the library already there. The build happens at the
first kernel launch, never at import. nvcc's output, with `-Xptxas -v`'s
register and shared-memory report, is kept in `build.log` beside the library.

Every C entry point returns `cudaGetLastError()`; `check` turns a nonzero code
into a RuntimeError. Pointers and the stream go through ctypes as `c_void_p`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "ffvc_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# entry point -> argument types (csrc/*.cu `extern "C"` signatures)
_SIGNATURES = {
    # x, codebook, xp, cp, n, k, c, channels, stream
    "ffvc_vq_split": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # xp, cp, c2, part_min, part_arg, out, n, k, channels, splits, stream
    "ffvc_vq_argmin": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, scale, bias, out, rows, d, dtype, stream
    "ffvc_ln_rows": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, scale, bias, out, rhat, inv, rows, d, centered, dtype, stream
    "ffvc_ln_rows_train": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # a, lda, sa, b, ldb, sb, b_kmajor, c, ldc, sc, res, ldr, sr, bias, bias_mode,
    # gelu, m, n, k, batch, splits, k_per_split, workspace, dtype, stream
    "ffvc_gemm": [_P, _L, _L, _P, _L, _L, _I, _P, _L, _L, _P, _L, _L, _P, _I,
                  _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    # a, lda, sa, a_mmajor, b, ldb, sb, b_kmajor, c, ldc, sc, c_f32, res, ldr, sr,
    # bias, bias_mode, gelu, gelu_grad, mul, out_f32, m, n, k, batch, batch_sum,
    # splits, k_per_split, workspace, dtype, stream
    "ffvc_gemm_train": [_P, _L, _L, _I, _P, _L, _L, _I, _P, _L, _L, _I, _P, _L, _L,
                        _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P, _I, _P],
    # x, scale, bias, out, total, d, dtype, stream
    "ffvc_affine_rows": [_P, _P, _P, _P, _L, _I, _I, _P],
    # dy, xsrc, inv_saved, scale, res, out, prod, rows, d, dtype, stream
    "ffvc_ln_bwd_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # a, out, rows, d, stream
    "ffvc_row_sum": [_P, _P, _I, _I, _P],
    # partial, out, batch, n, stream
    "ffvc_batch_sum": [_P, _P, _I, _L, _P],
    # a, out, partial, rows, cols, rows_per_chunk, stream
    "ffvc_col_sum": [_P, _P, _P, _I, _I, _I, _P],
    # dtype, out (int*)
    "ffvc_mixer_stream_blocks_per_sm": [_I, _P],
    # x, out, buf, r, xn, g1, g3, partial, barrier, ln1_w, ln1_b, t1, t1b, t2, t2b,
    # w1f, b1f, w2, b2, batch, layers, t, d, et, ec, (splits, k_per_split) x 4,
    # grid, dtype, stream
    "ffvc_mixer_stream": [_P] * 19 + [_I] * 6 + [_I] * 8 + [_I, _I, _P],
    # out (int*)
    "ffvc_mixer_stream_wgmma_blocks_per_sm": [_P],
    # x, out, buf, r, xn, g1, g3, partial, barrier, ln1_w, ln1_b, t1, t1b, t2, t2b,
    # w1f, b1f, w2, b2, batch, layers, t, d, et, ec, splits (int[4]), k_split (int[4]),
    # grid, stream
    "ffvc_mixer_stream_wgmma": [_P] * 19 + [_I] * 6 + [_P, _P, _I, _P],
    # a, lda, b, ldb, c, ldc, bias, act, gelu_grad, m, n, k, splits, k_per_split,
    # workspace, dtype, stream
    "ffvc_mlp_gemm": [_P, _L, _P, _L, _P, _L, _P, _I, _P, _I, _I, _I, _I, _I, _P, _I, _P],
    # a, sa, a_m_major, b, sb, b_mn_major, c, sc, m, n, k, batch, epi, bias, bias_rows,
    # res, mul, aux, act, bn, grid, pingpong, stream
    "ffvc_wgmma_gemm": [_P, _L, _I, _P, _L, _I, _P, _L, _I, _I, _I, _I, _I, _P, _I,
                        _P, _P, _P, _I, _I, _I, _I, _P],
    # x, gamma, beta, pre_bias, out, partial, rows, groups, cg, hw, slice, splits, eps, silu,
    # path, dtype, stream
    "ffvc_group_norm": [_P] * 6 + [_I] * 6 + [_F] + [_I] * 3 + [_P],
    # skip, h, vec, out, n, c, hw, path, dtype, stream
    "ffvc_residual_add": [_P] * 4 + [_L] + [_I] * 4 + [_P],
    # img, mats, out, b, h, w, ho, wo, c, border, dtype, stream
    "ffvc_warp_forward": [_P, _P, _P] + [_I] * 8 + [_P],
    # g, mats, grad, b, h, w, ho, wo, c, border, dtype, stream
    "ffvc_warp_adjoint": [_P, _P, _P] + [_I] * 8 + [_P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from csrc/ at first use and need the CUDA toolkit"
        )
    return str(path)


def library_path():
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libffvc_{h.hexdigest()[:16]}.so"


def _compile(out):
    """One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = str(Path(tmpdir) / f"{src.stem}.o")
            cmd = [nvcc, *compile_flags, "-c", "-o", obj, str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((cmd, obj, proc))
        log, failed = [], []
        for cmd, _, proc in jobs:
            output = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + output)
            if proc.returncode != 0:
                failed.append(output)
        if not failed:
            tmp = str(Path(tmpdir) / out.name)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(obj for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stderr)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f[-8000:] for f in failed))
        os.replace(tmp, out)  # atomic: a concurrent loader sees no half-written library


def load_library():
    """Build (if needed) and load the kernels' shared library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ffvc_error_string.argtypes = [ctypes.c_int]
            lib.ffvc_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err, what):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = load_library().ffvc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device):
    """PyTorch's current stream on `device`, as the integer the C side casts back."""
    return torch.cuda.current_stream(device).cuda_stream
