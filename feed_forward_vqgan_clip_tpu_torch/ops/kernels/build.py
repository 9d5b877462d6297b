"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled in one `nvcc` call into a shared library with
a plain C interface (no PyTorch headers, so the build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o libffvc_<hash>.so csrc/*.cu

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
# entry point -> argument types (csrc/*.cu `extern "C"` signatures)
_SIGNATURES = {
    # x, codebook, c2, part_min, part_arg, out, n, k, c, splits, codes_per_split, stream
    "ffvc_vq_argmin": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, scale, bias, out, rows, d, dtype, stream
    "ffvc_ln_rows": [_P, _P, _P, _P, _I, _I, _I, _P],
    # a, lda, sa, b, ldb, sb, b_kmajor, c, ldc, sc, res, ldr, sr, bias, bias_mode,
    # gelu, m, n, k, batch, splits, k_per_split, workspace, dtype, stream
    "ffvc_gemm": [_P, _L, _L, _P, _L, _L, _I, _P, _L, _L, _P, _L, _L, _P, _I,
                  _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
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
