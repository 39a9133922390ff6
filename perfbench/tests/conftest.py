"""Tiny configurations of the benchmark's two recipes, for the CPU tests:
the committed configuration with its tower and text widths cut and fp32,
the program's tower registry patched to the same widths. ``cuda``: the
card-only tests skip without a card, decided here at run time."""

import copy

import pytest
import torch

from perfbench.harness import spec

TINY = {
    "b16": ("clip-vitb16-segearth", {"image_size": 32, "patch_size": 8, "width": 32,
                                     "layers": 3, "head_width": 16, "mlp_ratio": 4.0,
                                     "embed_dim": 16, "quick_gelu": True}),
    "l14": ("remoteclip-vitl14-segearth", {"image_size": 32, "patch_size": 4, "width": 32,
                                           "layers": 4, "head_width": 16, "mlp_ratio": 4.0,
                                           "embed_dim": 24, "quick_gelu": False}),
}
TRAFFIC = {
    "serve": {"entry": "predict_raw", "images_per_call": 1, "image_hw": [64, 64], "pool": 4,
              "warmup_calls": 1, "check_calls": 2, "trace_calls": 1, "rate_per_s": 50.0},
    "batch": {"entry": "predict_batch_raw", "images_per_call": 2, "image_hw": [64, 64],
              "pool": 4, "warmup_calls": 1, "check_calls": 2, "trace_calls": 1},
}


def clip_config(config):
    from rs_ov_torch.core.config import CLIPConfig, TextConfig, VisionConfig

    t, x = config["tower"], config["text"]
    return CLIPConfig(
        embed_dim=t["embed_dim"],
        vision=VisionConfig(image_size=t["image_size"], patch_size=t["patch_size"],
                            width=t["width"], layers=t["layers"], output_dim=t["embed_dim"],
                            head_width=t["head_width"], mlp_ratio=t["mlp_ratio"]),
        text=TextConfig(context_length=x["context_length"], vocab_size=x["vocab_size"],
                        width=x["width"], heads=x["heads"], layers=x["layers"],
                        output_dim=t["embed_dim"]),
        quick_gelu=t["quick_gelu"])


@pytest.fixture
def tiny(monkeypatch):
    """tiny(variant, traffic) -> a spec.Cell of the tiny configuration."""
    import rs_ov_torch.pipeline.segmentor as segmentor

    def make(variant, traffic="serve"):
        name, tower = TINY[variant]
        config = copy.deepcopy(spec.load_json(f"{spec.REPO}/perfbench/configs/{name}.json"))
        config.update(tower=tower, dtype="float32", name=f"tiny-{variant}", file="-",
                      text={"width": 16, "layers": 1, "heads": 2, "context_length": 8,
                            "vocab_size": 32})
        config["recipe"].update(slide_crop=32, slide_stride=16,
                                outlier_suppression_cfg={"top_k": 3, "contamination_temp": 0.1})
        monkeypatch.setattr(segmentor, "get_model_config", lambda _name: clip_config(config))
        tr = {**TRAFFIC[traffic], "name": traffic}
        return spec.Cell(f"tiny.{traffic}", {"chips": 1}, config, tr, [], [])

    return make


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
