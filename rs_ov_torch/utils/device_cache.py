"""``device_cache``: ``functools.lru_cache`` for functions that build a
constant tensor on a device (a resize matrix, a tap table), so that it
crosses from the host once per process.

While ``torch.export`` traces, a tensor built inside the trace is a fake
one, and cached it would be handed to every later eager call. So under an
export the function runs with the trace's modes set aside: it builds (or
finds in the cache) a real tensor, which the trace records as a constant of
the program rather than as the ops that built it.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _disable_current_modes

__all__ = ["device_cache"]


def device_cache(fn):
    """``fn`` memoised on its (hashable) arguments; under ``torch.export``
    built outside the trace."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        if torch.compiler.is_exporting():
            with _disable_current_modes():
                return cached(*args)
        return cached(*args)

    wrapper.cache_clear, wrapper.cache_info = cached.cache_clear, cached.cache_info
    return wrapper
