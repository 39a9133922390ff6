"""The port's dataset converters (rs_ov_torch/data/converters/) against the
JAX package's (rs_ov/data/converters/): every subcommand of the CLI run by
both packages on one synthetic raw tree must write byte-equal output trees;
core.py's functions are held against the JAX package's on drawn inputs."""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from rs_ov.data.converters import convert as jax_convert
from rs_ov.data.converters import core as jax_core
from rs_ov_torch.data.converters import convert, core

ISPRS = [[0, 0, 0], [255, 255, 255], [0, 0, 255], [0, 255, 255], [0, 255, 0],
         [255, 255, 0], [255, 0, 0]]


def _save(path, arr, mode=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.asarray(arr, np.uint8), mode).save(path)


def _rgb(rng, h, w):
    return rng.randint(0, 256, (h, w, 3))


def _palette_map(rng, h, w, colours):
    return np.asarray(colours, np.uint8)[rng.randint(0, len(colours), (h, w))]


def _mask(rng, h, w, levels=(0, 255)):
    return np.asarray(levels)[rng.randint(0, len(levels), (h, w))]


def _raw_tree(root):
    """One raw download layout per subcommand family, small and odd-sized."""
    rng = np.random.RandomState(0)
    j = os.path.join
    for name in ("potsdam", "vaihingen"):
        for split in ("train", "validation"):
            _save(j(root, name, "images", split, "top_1.png"), _rgb(rng, 90, 100))
            _save(j(root, name, "labels", split, "top_1.png"), _palette_map(rng, 90, 100, ISPRS))
    _save(j(root, "uavid", "seq1", "Images", "000.png"), _rgb(rng, 70, 80))
    _save(j(root, "uavid", "seq1", "Labels", "000.png"),
          _palette_map(rng, 70, 80, list(jax_convert._UAVID_PALETTE.values())))
    for split in ("train", "val"):
        _save(j(root, "isaid", split, "images", "P0001.png"), _rgb(rng, 50, 70))
        _save(j(root, "isaid", split, "images", "P0001_instance_color_RGB.png"),
              _palette_map(rng, 50, 70, list(jax_convert._ISAID_PALETTE.values())))
    for split, domain in (("Train", "Rural"), ("Val", "Urban"), ("Test", "Rural")):
        _save(j(root, "loveda", split, domain, "images_png", "1.png"), _rgb(rng, 20, 24))
        if split != "Test":
            _save(j(root, "loveda", split, domain, "masks_png", "1.png"),
                  rng.randint(0, 8, (20, 24)))
    for region, name in (("aachen", "aachen_1.tif"), ("berlin", "berlin_2.tif")):
        _save(j(root, "openearthmap", region, "images", name), _rgb(rng, 16, 18))
        _save(j(root, "openearthmap", region, "labels", name), rng.randint(0, 9, (16, 18)))
    with open(j(root, "oem_val.txt"), "w") as f:
        f.write("berlin_2.tif\n")
    for split in ("train", "val"):
        _save(j(root, "whu", split, "OUT", "a.png"), _mask(rng, 30, 30))
    _save(j(root, "roadval", "gt", "r.png"), _mask(rng, 30, 30))
    _save(j(root, "wbs-si", "Masks", "w.png"), _mask(rng, 30, 30))
    _save(j(root, "xbd", "targets", "x_pre_disaster_target.png"),
          _mask(rng, 30, 30, levels=(0, 1, 2, 3, 4)))
    for name, sub in (("chn6-cug", "images"), ("deepglobe_road", "img")):
        _save(j(root, name, "gt", "7_mask.png"), _mask(rng, 24, 24))
        _save(j(root, name, sub, "7_sat.jpg"), _rgb(rng, 24, 24))
    for stem in ("austin27", "vienna3", "bellingham1"):  # val, test, train (skipped)
        _save(j(root, "inria", "images", f"{stem}.tif"), _rgb(rng, 50, 60))
        _save(j(root, "inria", "gt", f"{stem}.tif"), _mask(rng, 50, 60), "L")
    _save(j(root, "binary", "img", "b.png"), _rgb(rng, 40, 50))
    _save(j(root, "binary", "ann", "b.png"), _mask(rng, 40, 50))


def _argv(root, name, out):
    j = os.path.join
    args = {
        "potsdam": [j(root, "potsdam"), "--clip_size", "64", "--stride_size", "32"],
        "vaihingen": [j(root, "vaihingen"), "--clip_size", "48", "--stride_size", "40"],
        "uavid": [j(root, "uavid"), "--clip_size", "64", "--stride_size", "32"],
        "isaid": [j(root, "isaid"), "--patch", "64", "--stride", "32"],
        "loveda": [j(root, "loveda")],
        "openearthmap": [j(root, "openearthmap"), "--val_list", j(root, "oem_val.txt")],
        "whu": [j(root, "whu")], "roadval": [j(root, "roadval")],
        "wbs-si": [j(root, "wbs-si")], "xbd": [j(root, "xbd")],
        "chn6-cug": [j(root, "chn6-cug")], "deepglobe_road": [j(root, "deepglobe_road")],
        "inria": [j(root, "inria"), "--clip_size", "25", "--stride_size", "25"],
        "binary": [j(root, "binary", "img"), j(root, "binary", "ann"), "--clip_size", "32",
                   "--stride_size", "16"],
    }[name]
    return [name, *args, "-o", out]


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    _raw_tree(root)
    return root


SUBCOMMANDS = ("potsdam", "vaihingen", "uavid", "isaid", "loveda", "openearthmap", "whu",
               "roadval", "wbs-si", "xbd", "chn6-cug", "deepglobe_road", "inria", "binary")


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_subcommand_writes_the_jax_packages_tree(raw, name, tmp_path, monkeypatch):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    convert.main(_argv(raw, name, ours))
    monkeypatch.setattr(sys, "argv", ["convert", *_argv(raw, name, theirs)])
    jax_convert.main()
    got, want = _tree(ours), _tree(theirs)
    assert got, f"{name}: nothing written"
    assert sorted(got) == sorted(want)
    assert all(got[k] == want[k] for k in want)


def test_the_cli_runs_as_a_module(raw, tmp_path):
    import subprocess

    out = str(tmp_path / "whu")
    subprocess.run([sys.executable, "-m", "rs_ov_torch.data.converters.convert",
                    *_argv(raw, "whu", out)], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert sorted(_tree(out)) == ["train/label_cvt/a.png", "val/label_cvt/a.png"]


@pytest.mark.parametrize("h,w,clip,stride", [(512, 512, 512, 256), (1000, 700, 512, 256),
                                             (90, 100, 64, 32), (64, 64, 64, 64),
                                             (50, 130, 48, 40)])
def test_clip_boxes(h, w, clip, stride):
    np.testing.assert_array_equal(core.clip_boxes(h, w, clip, stride),
                                  jax_core.clip_boxes(h, w, clip, stride))


@pytest.mark.parametrize("seed", [0, 1])
def test_colour_maps(seed):
    rng = np.random.RandomState(seed)
    img = _palette_map(rng, 17, 23, ISPRS)
    np.testing.assert_array_equal(core.rgb_to_index_matmul(img, np.asarray(ISPRS)),
                                  jax_core.rgb_to_index_matmul(img, np.asarray(ISPRS)))
    pal = jax_convert._UAVID_PALETTE
    img = _palette_map(rng, 17, 23, list(pal.values()))
    np.testing.assert_array_equal(core.convert_from_color(img, pal, remap={7: 3}),
                                  jax_core.convert_from_color(img, pal, remap={7: 3}))


@pytest.mark.parametrize("pad_val", [None, 255])
def test_tile_image(tmp_path, pad_val):
    img = np.random.RandomState(2).randint(0, 256, (40, 70, 3)).astype(np.uint8)
    n = core.tile_image(img, str(tmp_path / "a"), "s", 48, 24, pad_val=pad_val)
    m = jax_core.tile_image(img, str(tmp_path / "b"), "s", 48, 24, pad_val=pad_val)
    assert n == m and _tree(str(tmp_path / "a")) == _tree(str(tmp_path / "b"))
