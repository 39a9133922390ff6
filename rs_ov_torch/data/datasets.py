"""Dataset registry (a copy of rs_ov/data/datasets.py): classes, palettes,
file suffixes and label semantics of the reference's ten custom datasets and
the mmseg built-ins its configs name. Label conventions (reduce_zero_label,
ignore_index=255) are mmseg's BaseSegDataset's.
"""

from __future__ import annotations

import dataclasses

__all__ = ["DatasetMeta", "DATASETS", "get_dataset_meta", "register_dataset"]


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    classes: tuple[str, ...]
    palette: tuple[tuple[int, int, int], ...] = ()
    img_suffix: str = ".png"
    seg_map_suffix: str = ".png"
    reduce_zero_label: bool = False
    ignore_index: int = 255


def _m(classes, palette=(), img=".png", seg=".png", rzl=False):
    return DatasetMeta(tuple(classes), tuple(tuple(p) for p in palette),
                       img, seg, rzl)


DATASETS: dict[str, DatasetMeta] = {
    # --- reference custom_datasets.py ---
    "OpenEarthMapDataset": _m(
        ("background", "bareland", "grass", "pavement", "road", "tree",
         "water", "cropland", "building"),
        [[0, 0, 0], [128, 0, 0], [0, 255, 36], [148, 148, 148], [255, 255, 255],
         [34, 97, 38], [0, 69, 255], [75, 181, 73], [222, 31, 7]],
        img=".tif", seg=".tif"),
    "WHUDataset": _m(("background", "building"), [[0, 0, 0], [255, 255, 255]]),
    "xBDDataset": _m(("background", "building"), [[0, 0, 0], [255, 255, 255]]),
    "CHN6_CUGDataset": _m(("background", "road"), [[0, 0, 0], [255, 255, 255]],
                          img=".jpg"),
    "RoadValDataset": _m(("background", "road"), [[0, 0, 0], [255, 255, 255]],
                         img=".jpg"),
    "UAVidDataset": _m(
        ("background", "building", "road", "car", "tree", "vegetation", "human"),
        [[0, 0, 0], [128, 0, 0], [128, 64, 128], [192, 0, 192], [0, 128, 0],
         [128, 128, 0], [64, 64, 0]]),
    "UDD5Dataset": _m(
        ("vegetation", "building", "road", "vehicle", "other"),
        [[107, 142, 35], [102, 102, 156], [128, 64, 128], [0, 0, 142], [0, 0, 0]],
        img=".JPG"),
    "VDDDataset": _m(
        ("other", "wall", "road", "vegetation", "vehicle", "roof", "water"),
        img=".JPG"),
    "InriaDataset": _m(("background", "building"), [[0, 0, 0], [255, 255, 255]]),
    "WaterDataset": _m(("background", "water"), [[0, 0, 0], [0, 235, 255]],
                       img=".jpg", seg=".jpg"),
    # --- mmseg built-ins used by the configs ---
    "ISPRSDataset": _m(
        ("impervious_surface", "building", "low_vegetation", "tree", "car",
         "clutter"),
        [[255, 255, 255], [0, 0, 255], [0, 255, 255], [0, 255, 0],
         [255, 255, 0], [255, 0, 0]],
        rzl=True),
    "PotsdamDataset": _m(
        ("impervious_surface", "building", "low_vegetation", "tree", "car",
         "clutter"),
        [[255, 255, 255], [0, 0, 255], [0, 255, 255], [0, 255, 0],
         [255, 255, 0], [255, 0, 0]],
        rzl=True),
    "LoveDADataset": _m(
        ("background", "building", "road", "water", "barren", "forest",
         "agricultural"),
        [[255, 255, 255], [255, 0, 0], [255, 255, 0], [0, 0, 255],
         [159, 129, 183], [0, 255, 0], [255, 195, 128]],
        rzl=True),
    "iSAIDDataset": _m(
        ("background", "ship", "store_tank", "baseball_diamond", "tennis_court",
         "basketball_court", "Ground_Track_Field", "Bridge", "Large_Vehicle",
         "Small_Vehicle", "Helicopter", "Swimming_pool", "Roundabout",
         "Soccer_ball_field", "plane", "Harbor"),
        img=".png", seg="_instance_color_RGB.png"),
}


def get_dataset_meta(name: str) -> DatasetMeta:
    if name not in DATASETS:
        raise KeyError(f"Unknown dataset type '{name}'. Known: {sorted(DATASETS)}")
    return DATASETS[name]


def register_dataset(name: str, meta: DatasetMeta) -> None:
    DATASETS[name] = meta
