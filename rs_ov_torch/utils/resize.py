"""Resize and pad ops as separable dense matrices (rs_ov/utils/resize.py).

The matrices are built in numpy exactly as the JAX package builds them, so
both packages resize with the same numbers at every size:

  * bilinear, align_corners=False, no antialias   (torch 'bilinear')
  * bicubic,  align_corners=False, no antialias, A=-0.75 (torch 'bicubic')
  * bicubic with an explicit coordinate scale (the pos-embed +0.1 quirk)
  * bicubic with antialias=True (GEM's pos-embed resample)
  * adaptive average pooling

Dtype round-trips follow the JAX package: the matrices are cast to the
input's dtype, products accumulate in fp32, the first pass is rounded to the
input's dtype, and the result is returned in the input's dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rs_ov_torch.utils.device_cache import device_cache

__all__ = ["resize_bilinear", "resize_bicubic", "resize_bicubic_scaled",
           "resize_bicubic_antialias", "adaptive_avg_pool2d", "reflect_pad_2d",
           "resize_bicubic_nhwc", "reflect_pad_nhwc"]


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        s = max((i + 0.5) * scale - 0.5, 0.0)  # torch clamps for linear modes
        i0 = min(int(np.floor(s)), in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        t = s - i0
        w[i, i0] += 1.0 - t
        w[i, i1] += t
    return w


def _cubic_weights(t: float, a: float = -0.75) -> np.ndarray:
    def w1(x):
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def w2(x):
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return np.array([w2(t + 1.0), w1(t), w1(1.0 - t), w2(2.0 - t)], dtype=np.float64)


@functools.lru_cache(maxsize=None)
def _bicubic_matrix_scaled(in_size: int, out_size: int, coord_scale: float) -> np.ndarray:
    """Bicubic (out, in) matrix mapping dst -> (dst + 0.5) * coord_scale - 0.5;
    border taps are index-clamped, as torch does."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        s = (i + 0.5) * coord_scale - 0.5
        i0 = int(np.floor(s))
        for tap, c in zip((i0 - 1, i0, i0 + 1, i0 + 2), _cubic_weights(s - i0)):
            w[i, min(max(tap, 0), in_size - 1)] += c
    return w.astype(np.float32)


def _bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    return _bicubic_matrix_scaled(in_size, out_size, in_size / out_size)


@functools.lru_cache(maxsize=None)
def _bicubic_antialias_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix for torch bicubic with antialias=True
    (rs_ov/utils/resize.py:118-149): torch's PIL-style resampling, the cubic
    (A = -0.5) support widened by the downscale factor, the tap window kept
    inside the input and each row renormalised; plain bicubic when
    upscaling but for A."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    kscale = max(scale, 1.0)
    support = 2.0 * kscale
    a = -0.5

    def cubic(x):
        x = abs(x)
        if x <= 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
        if x < 2.0:
            return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a
        return 0.0

    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = scale * (i + 0.5)
        lo = max(0, int(center - support + 0.5))
        hi = min(in_size, int(center + support + 0.5))
        vals = np.array([cubic((j - center + 0.5) / kscale) for j in range(lo, hi)])
        w[i, lo:hi] = vals / vals.sum()
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _adaptive_avg_matrix(in_size: int, out_size: int) -> np.ndarray:
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)
        w[i, start:end] = 1.0 / (end - start)
    return w


@device_cache
def _matrix(kind: str, in_size: int, out_size: int, device: torch.device,
            dtype: torch.dtype, coord_scale: float = 0.0) -> torch.Tensor:
    """A resize matrix on ``device``, rounded to ``dtype``, as fp32. Cached:
    a host-to-device copy from pageable memory waits for the stream, so each
    matrix crosses once per process, not once per call."""
    m = {"bilinear": lambda: _bilinear_matrix(in_size, out_size),
         "bicubic": lambda: _bicubic_matrix(in_size, out_size),
         "bicubic_scaled": lambda: _bicubic_matrix_scaled(in_size, out_size, coord_scale),
         "bicubic_aa": lambda: _bicubic_antialias_matrix(in_size, out_size),
         "adaptive_avg": lambda: _adaptive_avg_matrix(in_size, out_size)}[kind]()
    return torch.from_numpy(m).to(device).to(dtype).float()


def _apply_separable(x: torch.Tensor, kind: str, out_hw: tuple[int, int],
                     scales: tuple[float, float] = (0.0, 0.0)) -> torch.Tensor:
    """The (out_h, in_h) and (out_w, in_w) matrices on the last two axes."""
    dtype = x.dtype
    wh = _matrix(kind, x.shape[-2], out_hw[0], x.device, dtype, scales[0])
    ww = _matrix(kind, x.shape[-1], out_hw[1], x.device, dtype, scales[1])
    y = torch.einsum("oh,...hw->...ow", wh, x.float()).to(dtype)
    return torch.einsum("pw,...ow->...op", ww, y.float()).to(dtype)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """F.interpolate(x, size=out_hw, mode='bilinear') on (..., H, W)."""
    return _apply_separable(x, "bilinear", out_hw)


def resize_bicubic(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """F.interpolate(x, size=out_hw, mode='bicubic') on (..., H, W)."""
    return _apply_separable(x, "bicubic", out_hw)


def resize_bicubic_scaled(x: torch.Tensor, out_hw: tuple[int, int],
                          coord_scales: tuple[float, float]) -> torch.Tensor:
    """F.interpolate(x, scale_factor=1/coord_scales, mode='bicubic',
    recompute_scale_factor=False) on (..., H, W)."""
    return _apply_separable(x, "bicubic_scaled", out_hw, coord_scales)


def resize_bicubic_antialias(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """F.interpolate(x, size=out_hw, mode='bicubic', antialias=True) on (..., H, W)."""
    return _apply_separable(x, "bicubic_aa", out_hw)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """F.adaptive_avg_pool2d on (..., H, W)."""
    return _apply_separable(x, "adaptive_avg", out_hw)


def resize_bicubic_nhwc(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """resize_bicubic for [..., H, W, C]: the same matrices on axes (-3, -2)."""
    dtype = x.dtype
    wh = _matrix("bicubic", x.shape[-3], out_hw[0], x.device, dtype)
    ww = _matrix("bicubic", x.shape[-2], out_hw[1], x.device, dtype)
    y = torch.einsum("oh,...hwc->...owc", wh, x.float()).to(dtype)
    return torch.einsum("pw,...owc->...opc", ww, y.float()).to(dtype)


@device_cache
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    if pad >= n:
        raise ValueError(f"reflect pad {pad} needs a dimension above it, got {n}")
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _reflect_pad(x: torch.Tensor, pad: int, dims: tuple[int, int]) -> torch.Tensor:
    for dim in dims:
        x = x.index_select(dim, _reflect_index(x.shape[dim], pad, x.device))
    return x


def reflect_pad_2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """F.pad(x, [pad] * 4, mode='reflect') on the last two axes."""
    return _reflect_pad(x, pad, (x.ndim - 2, x.ndim - 1))


def reflect_pad_nhwc(x: torch.Tensor, pad: int) -> torch.Tensor:
    """reflect_pad_2d for [..., H, W, C]."""
    return _reflect_pad(x, pad, (x.ndim - 3, x.ndim - 2))
