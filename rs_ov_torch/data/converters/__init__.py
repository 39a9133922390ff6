"""Offline dataset converters: raw downloads -> mmseg-layout tiles (numpy + PIL)."""

from rs_ov_torch.data.converters.core import (  # noqa: F401
    clip_boxes,
    convert_from_color,
    rgb_to_index_matmul,
    tile_image,
)
