"""Build and load the port's CUDA kernels.

Every ``rs_ov_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, into ``rs_ov_torch/_build/`` (ignored by git), and
is keyed on a hash of the sources and flags, so an edited source rebuilds.
There is no fallback: a missing ``nvcc`` or a failed build raises.

Each C entry point takes device pointers, ints and the CUDA stream, launches
on that stream and returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["load_library", "check", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: pointers, ints, stream; every entry point returns cudaError_t
_SIGNATURES = {
    "rs_range_logits": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rs_jbu_epilogue": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_jbu_epilogue_classify": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    lib_path = os.path.join(BUILD_DIR, f"librs_ov_kernels_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
        with open(lib_path + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)  # atomic: a concurrent process never sees half a file
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rs_error_string.argtypes = [_I]
    lib.rs_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = load_library().rs_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")
