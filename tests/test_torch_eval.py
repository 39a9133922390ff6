"""The port's evaluation entry against the JAX package's, on the CPU: the
dataset loader on every committed data_synth config, the IoU metric (host
and device paths), run_eval on a tiny Potsdam-layout dataset with the same
tiny weights (per image, batched with a padded tail, two shards merged),
the prediction dtype, build_model_overrides and the two CLIs."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eval as jax_eval_cli
from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.core.params import init_clip_params
from rs_ov.data.datasets import DATASETS as JAX_DATASETS
from rs_ov.data.loader import SegDataset as JaxSegDataset
from rs_ov.evalsuite import metrics as jax_metrics
from rs_ov.evalsuite.config import load_config as jax_load_config
from rs_ov.evalsuite.runner import run_eval as jax_run_eval
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.upsample.jbu import init_jbu_one_params
from rs_ov_torch import eval as port_eval_cli
from rs_ov_torch import eval_all as port_eval_all
from rs_ov_torch.data.datasets import DATASETS, get_dataset_meta
from rs_ov_torch.data.loader import SegDataset
from rs_ov_torch.evalsuite import metrics
from rs_ov_torch.evalsuite.config import load_config
from rs_ov_torch.evalsuite.runner import merge_eval_results, run_eval
from rs_ov_torch.pipeline.segmentor import SegmentorEx

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POTSDAM_CFG = os.path.join(REPO, "configs", "cfg_potsdam.py")
SYNTH = ["cfg_chn6-cug", "cfg_deepglobe_road", "cfg_massachusetts_road", "cfg_spacenet_road",
         "cfg_openearthmap", "cfg_whu_sat_II", "cfg_wbs-si"]
# the tiny arch of tools/parity_check.py:68-70
CFG = CLIPConfig(
    embed_dim=32,
    vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=4,
                        output_dim=32, head_width=32),
    text=TextConfig(context_length=77, vocab_size=49408, width=48, heads=2,
                    layers=2, output_dim=32))


def _dataset(load, cls, name, **kw):
    ds = load(os.path.join("configs", f"{name}.py"))["test_dataloader"]["dataset"]
    meta = dataclasses.replace(get_dataset_meta(ds["type"]), **{
        k: ds[k] for k in ("img_suffix", "seg_map_suffix", "reduce_zero_label") if k in ds})
    return cls(ds["type"], ds["data_prefix"]["img_path"], ds["data_prefix"].get("seg_map_path"),
               meta=meta, **kw)


@pytest.mark.parametrize("name", SYNTH)
def test_dataset_matches_jax_on_committed_data(name, monkeypatch):
    """Every committed data_synth config, under RS_OV_DATA_ROOT: the same
    uint8 images (raw) or normalised CHW images, int64 labels and metas,
    whole and as shard 1 of 2 cut to one sample."""
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("RS_OV_DATA_ROOT", "data_synth")
    assert {k: dataclasses.asdict(v) for k, v in DATASETS.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_DATASETS.items()}
    for kw in (dict(raw=True), dict(raw=False), dict(raw=True, shard=(1, 2), max_samples=1)):
        ours = list(_dataset(load_config, SegDataset, name, **kw))
        theirs = list(_dataset(jax_load_config, JaxSegDataset, name, **kw))
        assert len(ours) == len(theirs) == (1 if "shard" in kw else 2)
        for a, b in zip(ours, theirs):
            assert a.img.dtype == b.img.dtype == (np.uint8 if kw["raw"] else np.float32)
            np.testing.assert_array_equal(a.img, b.img)
            assert a.seg.dtype == b.seg.dtype == np.int64
            np.testing.assert_array_equal(a.seg, b.seg)
            assert a.meta == b.meta


def test_metric_matches_jax_exactly():
    rng = np.random.RandomState(0)
    c = 6
    pred = rng.randint(0, c, (3, 40, 50))
    label = rng.randint(0, c, (3, 40, 50))
    label[rng.rand(3, 40, 50) < 0.2] = 255
    want = jax_metrics.confusion_update(pred.reshape(-1), label.reshape(-1), c)
    np.testing.assert_array_equal(metrics.confusion_update(pred.reshape(-1), label.reshape(-1), c),
                                  want)
    state = np.arange(4 * c, dtype=np.float32).reshape(4, c)
    got = metrics.device_confusion_update(torch.from_numpy(state), torch.from_numpy(pred).to(torch.uint8),
                                          torch.from_numpy(label.astype(np.uint8)), c)
    ref = jax_metrics.device_confusion_update(jnp.asarray(state), jnp.asarray(pred, jnp.uint8),
                                              jnp.asarray(label, jnp.uint8), c)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ours, theirs = metrics.IoUMetric(c, class_names=tuple("abcdef")), jax_metrics.IoUMetric(
        c, class_names=tuple("abcdef"))
    for m in (ours, theirs):
        m.process(pred, label)
        m.merge(want)
    assert ours.compute() == theirs.compute()


@pytest.fixture(scope="module")
def potsdam_root(tmp_path_factory):
    """Three 96x96 images with Potsdam labels (0 = ignored, 1-6 the classes)
    in configs/cfg_potsdam.py's layout under a data root."""
    from PIL import Image

    root = tmp_path_factory.mktemp("root")
    base = root / "payload" / "datasets" / "Potsdam"
    (base / "images" / "validation").mkdir(parents=True)
    (base / "annotations" / "validation").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (96, 96, 3), np.uint8)).save(
            base / "images" / "validation" / f"img{i}.png")
        Image.fromarray(rng.randint(0, 7, (96, 96)).astype(np.uint8)).save(
            base / "annotations" / "validation" / f"img{i}.png")
    return root


@pytest.fixture(scope="module")
def segmentors():
    """The production recipe on the tiny arch, the same weights in both."""
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    kw = dict(clip_type="CLIP", vit_type="ViT-B/16", model_type="Experimental",
              name_path=os.path.join(REPO, "configs", "cls_potsdam.txt"), slide_stride=32,
              slide_crop=64, global_debias_factor=0.2, apply_sim_feat_up=True,
              apply_outlier_suppression=True, outlier_suppression_cfg=dict(top_k=5),
              apply_similarity_enhancement=True, prob_thd=0.1, bg_idx=5, clip_config=CFG,
              params=to_np(init_clip_params(jax.random.PRNGKey(0), CFG)),
              upsampler_params=to_np(init_jbu_one_params(jax.random.PRNGKey(1), 32)))
    return kw, JaxSegmentorEx(**kw), SegmentorEx(**kw, device="cpu")


def _close(a, b, keys=("aAcc", "mIoU", "mAcc")):
    for k in keys:
        assert abs(a[k] - b[k]) <= 0.1, (k, a[k], b[k])
    assert a["num_images"] == b["num_images"]


def test_run_eval_matches_jax(segmentors, potsdam_root, tmp_path, monkeypatch):
    """Per image and with batch_images=2 (the tail of one image padded):
    aAcc, mIoU and mAcc within 0.1 points of the JAX runner's; two shards
    merged equal the single run; the result files are written."""
    _, jax_seg, seg = segmentors
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("RS_OV_DATA_ROOT", str(potsdam_root))
    want = jax_run_eval(POTSDAM_CFG, work_dir=str(tmp_path / "jax"), segmentor=jax_seg,
                        verbose=False)
    got = run_eval(POTSDAM_CFG, work_dir=str(tmp_path / "one"), segmentor=seg, verbose=False)
    _close(got, want)
    assert got["num_images"] == 3 and got["img_per_sec_sustained"] > 0
    batched = run_eval(POTSDAM_CFG, work_dir=str(tmp_path / "two"), segmentor=seg,
                       batch_images=2, verbose=False)
    _close(batched, jax_run_eval(POTSDAM_CFG, work_dir=str(tmp_path / "jax2"),
                                 segmentor=jax_seg, batch_images=2, verbose=False))
    _close(batched, got)
    for rank in (0, 1):
        run_eval(POTSDAM_CFG, work_dir=str(tmp_path / "dist" / f"rank{rank}"), shard=(rank, 2),
                 segmentor=seg, verbose=False)
    merged = merge_eval_results(str(tmp_path / "dist"), verbose=False)
    assert merged["num_shards"] == 2
    for k in ("aAcc", "mIoU", "mAcc", "num_images"):
        assert merged[k] == got[k], k
    for name in ("results.csv", "results.txt", "cfg_potsdam_per_class.json", "metric_state.npz"):
        assert os.path.exists(tmp_path / "one" / name), name
    # the -m entry of the CLI merges the same shards
    out = subprocess.run([sys.executable, "-m", "rs_ov_torch.eval", "--merge",
                          str(tmp_path / "dist")], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=120)
    assert json.loads(out.stdout[out.stdout.index("{"):])["mIoU"] == got["mIoU"]


@pytest.mark.parametrize("pred_dtype", [None, "uint8"])
def test_pred_dtype_matches_jax(segmentors, pred_dtype):
    """pred_sem_seg is int32 by default, as in the JAX package, and uint8
    when asked: postprocess_logits of both packages on the same logits, and
    SegmentorEx's pass-through."""
    from rs_ov.pipeline.postprocess import postprocess_logits as jax_post
    from rs_ov_torch.pipeline.postprocess import postprocess_logits, query_onehot

    logits = np.random.RandomState(2).randn(8, 12, 14).astype(np.float32) * 0.05
    onehot = query_onehot([0, 0, 1, 2, 3, 4, 5, 5])
    opts = dict(logit_scale=50.0, prob_thd=0.3, bg_idx=5)
    want = jax_post(jnp.asarray(logits), jnp.asarray(onehot), **opts,
                    **({} if pred_dtype is None else {"pred_dtype": jnp.dtype(pred_dtype)}))[1]
    got = postprocess_logits(torch.from_numpy(logits), torch.from_numpy(onehot), **opts,
                             **({} if pred_dtype is None else {"pred_dtype": torch.uint8}))[1]
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kw, _, _ = segmentors
    img = np.random.RandomState(1).randint(0, 256, (1, 64, 64, 3), np.uint8)
    pred = SegmentorEx(**kw, pred_dtype=pred_dtype, device="cpu").predict_raw(img)[0]
    assert pred["pred_sem_seg"].dtype == got.dtype


def test_forward_feature_matches_jax(segmentors):
    """forward_feature: one-shot logits of a normalised 64x80 image, resized
    to 72x96, within 2e-3 of the JAX package's (tools/parity_check.py's
    logits tolerance)."""
    _, jax_seg, seg = segmentors
    img = np.random.RandomState(3).randn(1, 3, 64, 80).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jax_seg.forward_feature(x, logit_size=(72, 96)))(img))
    got = seg.forward_feature(img, logit_size=(72, 96)).numpy()
    assert got.shape == want.shape == (1, 8, 72, 96)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_build_model_overrides_match_jax(monkeypatch):
    """The cases of tests/test_eval_harness.py:348-390: a checkpoint without
    --jbu-stages pins 4 stages, explicit stages win."""
    monkeypatch.delenv("RS_OV_JBU_STAGES", raising=False)
    cases = [(None, None, None), ("/nonexistent/ViT-B-16.pt", None, None),
             (None, "/nonexistent/jbu.ckpt", None), ("/nonexistent/ViT-B-16.pt", None, 3),
             (None, None, 2), ("a.pt", "b.ckpt", None)]
    for case in cases:
        assert port_eval_cli.build_model_overrides(*case) == jax_eval_cli.build_model_overrides(*case)
    monkeypatch.setenv("RS_OV_JBU_STAGES", "2")
    assert (port_eval_cli.build_model_overrides("a.pt", None, None)
            == jax_eval_cli.build_model_overrides("a.pt", None, None))


def test_eval_clis_run_a_tiny_config(segmentors, potsdam_root, tmp_path, monkeypatch, capsys):
    """rs_ov_torch.eval --device cpu on cfg_potsdam with tiny weights (given
    through run_eval's model_overrides), and eval_all over it and a config
    whose dataset is missing, which gives an error entry."""
    kw, _, _ = segmentors
    tiny = {k: kw[k] for k in ("clip_config", "params", "upsampler_params", "slide_stride",
                               "slide_crop", "outlier_suppression_cfg")}
    for mod in (port_eval_cli, port_eval_all):
        real = mod.build_model_overrides
        monkeypatch.setattr(mod, "build_model_overrides",
                            lambda *a, real=real: {**real(*a), **tiny})
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("RS_OV_DATA_ROOT", str(potsdam_root))
    port_eval_cli.main(["--config", POTSDAM_CFG, "--device", "cpu", "--work-dir",
                        str(tmp_path / "one"), "--batch-images", "2",
                        "--save-seg-dir", str(tmp_path / "seg")])
    printed = json.loads(capsys.readouterr().out)
    assert printed["num_images"] == 3 and 0 <= printed["mIoU"] <= 100
    assert sorted(os.listdir(tmp_path / "seg")) == ["img0.png", "img1.png", "img2.png"]
    missing = tmp_path / "cfg_missing.py"
    missing.write_text(f"_base_ = ['{os.path.join(REPO, 'configs', 'cfg_loveda.py')}']\n")
    monkeypatch.setattr(port_eval_all, "CONFIGS", [POTSDAM_CFG, str(missing)])
    summary = port_eval_all.main(["--device", "cpu", "--work-dir", str(tmp_path / "all"),
                                  "--json-out", str(tmp_path / "s.json")])
    assert json.loads((tmp_path / "s.json").read_text()) == summary
    assert summary[POTSDAM_CFG]["mIoU"] == pytest.approx(printed["mIoU"], abs=0.1)
    assert "error" in summary[str(missing)]
