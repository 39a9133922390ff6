"""Native (C++/OpenMP) host-side decode and normalisation, bound via ctypes
(the port's copy of rs_ov/native).

``decode.cpp`` (libpng, libjpeg) and ``preprocess.cpp`` are compiled with
``g++`` at first use into ``rs_ov_torch/_build/`` (ignored by git), keyed on
a hash of the sources. Where the decoder does not compile, link or load
(no libpng / libjpeg) the library holds the normalisation alone; where
``g++`` fails entirely there is no library. Each entry point then degrades as the JAX package's does:
``decode_rgb`` / ``decode_gray`` return None (the caller falls back to PIL),
``normalize_hwc_to_chw`` runs in numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

__all__ = ["get_lib", "decode_available", "decode_rgb", "decode_gray",
           "normalize_hwc_to_chw"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "preprocess.cpp")
_DECODE_SRC = os.path.join(_DIR, "decode.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_lock = threading.Lock()
_lib = None
_tried = False


def _compile(tag: str, srcs: list[str], libs: list[str]) -> str | None:
    """The library of ``srcs`` in BUILD_DIR, compiled unless it is there;
    None where g++ fails."""
    digest = hashlib.sha256()
    for src in (_SRC, _DECODE_SRC):
        with open(src, "rb") as f:
            digest.update(f.read())
    path = os.path.join(BUILD_DIR, f"libpreprocess_{tag}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17", *srcs,
                        "-o", tmp, *libs], check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)  # atomic: a concurrent process never sees half a file
        return path
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None


def get_lib():
    """The loaded library, built at first use: with the decoders where
    libpng and libjpeg compile, link and load, else the normalisation alone;
    None where g++ fails."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = None
        for tag, srcs, libs in (("decode", [_SRC, _DECODE_SRC], ["-lpng", "-ljpeg"]),
                                ("plain", [_SRC], [])):
            path = _compile(tag, srcs, libs)
            try:
                lib = ctypes.CDLL(path) if path else None
            except OSError:  # built where the shared libraries differ
                lib = None
            if lib is not None:
                break
        if lib is None:
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.normalize_hwc_to_chw.argtypes = [u8p, f32p, i64, i64, f32p, f32p]
        lib.normalize_hwc_to_chw_f32.argtypes = [f32p, f32p, i64, i64, f32p, f32p]
        if hasattr(lib, "decode_header"):
            lib.decode_header.argtypes = [u8p, i64, i64p, i64p]
            lib.decode_rgb.argtypes = lib.decode_gray.argtypes = [u8p, i64, u8p, i64p, i64p]
            for fn in (lib.decode_header, lib.decode_rgb, lib.decode_gray):
                fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def decode_available() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "decode_header")


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def normalize_hwc_to_chw(img: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """HWC uint8/float32 -> normalised CHW float32 (OpenMP, numpy fallback)."""
    lib = get_lib()
    h, w = img.shape[:2]
    mean = np.ascontiguousarray(mean, np.float32)
    inv_std = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    if lib is None or img.shape[2] != 3:
        x = (img.astype(np.float32) - mean) / np.asarray(std, np.float32)
        return np.ascontiguousarray(x.transpose(2, 0, 1))
    out = np.empty((3, h, w), np.float32)
    if img.dtype == np.uint8:
        src = np.ascontiguousarray(img)
        lib.normalize_hwc_to_chw(_u8ptr(src), _fptr(out), h, w, _fptr(mean), _fptr(inv_std))
    else:
        src = np.ascontiguousarray(img, np.float32)
        lib.normalize_hwc_to_chw_f32(_fptr(src), _fptr(out), h, w, _fptr(mean),
                                     _fptr(inv_std))
    return out


def _decode(data: bytes, gray: bool):
    """bytes -> [H, W(, 3)] uint8, or None (the caller falls back to PIL)."""
    if not decode_available():
        return None
    lib = get_lib()
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int64(), ctypes.c_int64()
    if lib.decode_header(_u8ptr(buf), buf.size, ctypes.byref(h), ctypes.byref(w)) < 0:
        return None
    out = np.empty((h.value, w.value) if gray else (h.value, w.value, 3), np.uint8)
    fn = lib.decode_gray if gray else lib.decode_rgb
    if fn(_u8ptr(buf), buf.size, _u8ptr(out), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None  # -2: 16-bit / exotic color type -> PIL
    return out


def decode_rgb(data: bytes):
    """Encoded PNG/JPEG bytes -> [H, W, 3] uint8 RGB, or None for the PIL
    fallback (unknown format, 16-bit PNG, decode error)."""
    return _decode(data, gray=False)


def decode_gray(data: bytes):
    """Encoded PNG/JPEG bytes -> [H, W] uint8 labels (palette PNGs keep raw
    indices, RGB-coded labels collapse to channel 0, as PIL's path), or None
    for the PIL fallback."""
    return _decode(data, gray=True)
