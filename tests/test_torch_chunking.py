"""The decontam / JBU / classify chunk of ``SegmentorEx`` (pipeline/segmentor.py):
``chunk_crops`` sizes it from ``chunk_peak_bytes``, the modelled peak of a
crop's temporaries, under a byte budget of a quarter of the card's memory;
on the CPU, for CTD and for the upsamplers the model does not reckon it
stays 2; ``tile_chunk`` and ``RS_OV_TILE_CHUNK`` override it, in that
order; each ``rs_ov/entry/chunk`` span says how many chunks its call ran.
On a card: a batch of 8 512x512 tiles runs as one chunk and gives what chunks
of 2 give, the model's estimate is held against ``torch.cuda.max_memory_allocated``
on every route, 1, 2 and 4 stages, both upsamplers and two widths, and at 4
stages one chunk of 79 crops, whose padded source passes 2^31 elements, gives
what chunks of 8 give, bit for bit:

    python -m pytest tests/test_torch_chunking.py --noconftest -m cuda -s
"""

import os

import numpy as np
import pytest
import torch

from rs_ov_torch.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov_torch.pipeline.segmentor import SegmentorEx, chunk_crops, chunk_peak_bytes
from rs_ov_torch.utils import profiling

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
CARD = 80 * 10 ** 9  # an 80 GB card: the default budget is a quarter of it
BUDGET = CARD // 4
ONE, STACK = 11 * 11, 7 * 7  # jbu_one's and jbu_stack's taps
# (crops a call, token grid, width C) of the benchmark's cells: 8 or 1
# 512x512 tiles of 16 crops of 224, ViT-B/16 (14 x 14 tokens, 512 wide) and
# ViT-L/14 (16 x 16, 768)
POTSDAM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "cls_potsdam.txt")  # 8 queries, 6 classes
CELLS = {"b16.batch8": (128, 14, 512), "b16.serve1": (16, 14, 512),
         "l14.batch8": (128, 16, 768), "l14.serve1": (16, 16, 768)}


def _crops(crops, grid, width, stages=2, route="nhwc_classify", dtype=BF16,
           upsampler="jbu_one", taps=ONE, queries=8, budget=BUDGET):
    return chunk_crops(crops, (grid, grid), stages, upsampler, route, width, taps, queries,
                       dtype, (224, 224), budget)


def _per_crop(grid, width, stages=2, route="nhwc_classify", dtype=BF16, taps=ONE,
              queries=8):
    return chunk_peak_bytes((grid, grid), stages, route, width, taps, queries, dtype,
                            (224, 224))


def test_the_rule_is_a_pure_function_of_the_call():
    """The same call gives the same Python int; the chunk is the largest
    count whose modelled peak fits, capped at the crops; more width, stages,
    taps, queries or bytes an element never give a larger chunk."""
    got = _crops(4096, 14, 512)
    assert type(got) is int and got == _crops(4096, 14, 512)
    per = _per_crop(14, 512)
    assert got == BUDGET // per and got * per <= BUDGET < (got + 1) * per
    assert _crops(16, 14, 512) == 16
    base = dict(crops=4096, grid=14, width=512)
    for over in (dict(width=768), dict(stages=3), dict(grid=16), dict(dtype=F32),
                 dict(route="channel_first"), dict(queries=128)):
        assert _crops(**{**base, **over}) <= got, over
    assert _crops(4096, 14, 512, upsampler="jbu_stack", taps=STACK) >= got


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_runs_one_chunk_a_call(cell):
    crops, grid, width = CELLS[cell]
    assert _crops(crops, grid, width) == crops


def test_four_stages_split_by_the_model():
    """``RS_OV_JBU_STAGES=4`` at B/16: the last stage upsamples to 224 x
    224, about 270 MB a crop, so 128 crops split in two chunks under 20 GB
    (not 64 chunks of 2); the fp32 channel-first route at 4 stages, about
    370 MB a crop, in three."""
    per = _per_crop(14, 512, stages=4)
    assert 250e6 < per < 290e6, per
    chunk = _crops(128, 14, 512, stages=4)
    assert 64 <= chunk < 128 and -(-128 // chunk) == 2
    f32 = _crops(128, 14, 512, stages=4, route="channel_first", dtype=F32)
    assert f32 < chunk and -(-128 // f32) == 3


def test_an_unreckoned_upsampler_keeps_two():
    for name in ("bilinear", "resize_conv", "ifa", "carafe", "sapa"):
        assert _crops(128, 14, 512, upsampler=name, route="channel_first") == 2


@pytest.mark.parametrize("budget_crops", [0, 1, 3, 7.5])
def test_a_small_budget_gives_a_chunk_that_fits(budget_crops):
    per = _per_crop(16, 768)
    got = _crops(128, 16, 768, budget=int(budget_crops * per))
    assert got == max(1, int(budget_crops)) and (got == 1 or got * per <= budget_crops * per)


# ---------------------------------------------------------------------------
# the segmentor's default and its overrides
# ---------------------------------------------------------------------------

def _cfg(embed, patch=16):
    return CLIPConfig(embed_dim=embed,
                      vision=VisionConfig(image_size=32, patch_size=patch, width=32, layers=1,
                                          output_dim=embed, head_width=16),
                      text=TextConfig(context_length=8, vocab_size=32, width=16, heads=2,
                                      layers=1, output_dim=embed))


def _names(tmp_path):
    names = tmp_path / "cls.txt"
    names.write_text("background\nbuilding,house\nroad\n")
    return str(names)


def _segmentor(tmp_path, embed=16, device="cpu", **over):
    kw = dict(name_path=_names(tmp_path), slide_crop=32, slide_stride=16,
              global_debias_factor=0.2, apply_sim_feat_up=True,
              sim_feat_up_cfg=dict(model_name="jbu_one", num_stages=2), clip_config=_cfg(embed),
              query_features=np.random.RandomState(0).randn(4, embed).astype(np.float32),
              device=device)
    kw.update(over)
    return SegmentorEx(**kw)


def _call_chunk(seg, crops, grid=14, width=16, dtype=BF16):
    tokens = torch.zeros((crops, grid * grid, width), dtype=dtype)
    return seg._chunk_size(tokens, (grid, grid), (224, 224))


def test_the_cpu_keeps_the_jax_default(tmp_path):
    seg = _segmentor(tmp_path)
    assert seg._chunk_budget is None
    assert _call_chunk(seg, 128) == seg._chunk_size() == 2


def test_the_budget_sizes_the_card_default(tmp_path, monkeypatch):
    """With a card's budget the call's chunk follows the rule, through the
    call's route; no tokens (and CTD) keep 2."""
    monkeypatch.delenv("RS_OV_TILE_CHUNK", raising=False)
    seg = _segmentor(tmp_path)
    seg._chunk_budget = BUDGET
    monkeypatch.setattr(seg, "_jbu_route", lambda tokens: "nhwc_classify")
    assert _call_chunk(seg, 128) == 128 and seg._chunk_size() == 2
    cf = _per_crop(14, 16, route="channel_first", queries=4)
    seg._chunk_budget = 3 * cf
    assert _call_chunk(seg, 128) == 3 * cf // _per_crop(14, 16, queries=4) > 3
    monkeypatch.setattr(seg, "_jbu_route", lambda tokens: "channel_first")
    assert _call_chunk(seg, 128) == 3
    ctd = _segmentor(tmp_path, apply_ctd=True)
    ctd._chunk_budget = BUDGET
    assert _call_chunk(ctd, 128) == 2
    bilinear = _segmentor(tmp_path, sim_feat_up_cfg=dict(model_name="bilinear"))
    bilinear._chunk_budget = BUDGET
    assert _call_chunk(bilinear, 128) == 2


def test_the_overrides_keep_their_order(tmp_path, monkeypatch):
    """tile_chunk, then RS_OV_TILE_CHUNK (read at call time, "0" runs all at
    once), then the default; without SimFeatUp no chunking."""
    monkeypatch.delenv("RS_OV_TILE_CHUNK", raising=False)
    for kw, env, want in (({}, None, 128), ({"tile_chunk": 4}, None, 4), ({}, "3", 3),
                          ({"tile_chunk": 4}, "3", 4), ({}, "0", 0),
                          ({"apply_sim_feat_up": False}, None, 0)):
        seg = _segmentor(tmp_path, **kw)
        seg._chunk_budget = BUDGET
        monkeypatch.setattr(seg, "_jbu_route", lambda tokens: "nhwc_classify")
        if env is None:
            monkeypatch.delenv("RS_OV_TILE_CHUNK", raising=False)
        else:
            monkeypatch.setenv("RS_OV_TILE_CHUNK", env)
        assert _call_chunk(seg, 128) == want, (kw, env)


def _chunk_spans(seg, images):
    with profiling.recording():
        seg.predict_batch_raw(images)
    return [r["attrs"] for r in profiling.spans() if r["name"] == "rs_ov/entry/chunk"]


def test_each_chunk_span_counts_the_chunks_of_its_call(tmp_path, monkeypatch):
    """A 48 x 64 image is 6 crops of 32: 2 images in chunks of 2 are 6
    spans of 2 crops, each of=6; with a chunk of all 12 crops, one span.
    Each span holds its chunk's modelled peak (the CPU's channel-first
    route, 4 x 4 tokens, 4 queries, fp32), and with a budget the budget."""
    monkeypatch.delenv("RS_OV_TILE_CHUNK", raising=False)
    images = np.random.RandomState(3).randint(0, 256, (2, 48, 64, 3), np.uint8)
    seg = _segmentor(tmp_path, clip_config=_cfg(16, patch=8))
    per = chunk_peak_bytes((4, 4), 2, "channel_first", 16, ONE, 4, F32, (32, 32))

    def chunk(crops, of, **budget):
        return {"crops": crops, "of": of, "peak_bytes": crops * per, **budget}

    assert _chunk_spans(seg, images) == [chunk(2, 6)] * 6
    seg._chunk_budget = BUDGET
    assert _chunk_spans(seg, images) == [chunk(12, 1, budget=BUDGET)]
    seg.tile_chunk = 5
    assert _chunk_spans(seg, images) == ([chunk(5, 3, budget=BUDGET)] * 2
                                         + [chunk(2, 3, budget=BUDGET)])
    bilinear = _segmentor(tmp_path, clip_config=_cfg(16, patch=8),
                          sim_feat_up_cfg=dict(model_name="bilinear"))
    assert _chunk_spans(bilinear, images) == [{"crops": 2, "of": 6}] * 6


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the byte model is held against its allocator")
    return torch.device("cuda")


SERVE_TOL, TAU = 1e-3, 0.005  # chip_smoke's bounds between two programs of the JBU route


def _chunk_peak(seg, fn):
    """fn(), and the peak of memory allocated in ``seg._chunked_decontam``
    above what was allocated when it began."""
    inner, peaks = seg._chunked_decontam, []

    def measured(*args):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = inner(*args)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - start)
        return out

    seg._chunked_decontam = measured
    try:
        return fn(), peaks
    finally:
        del seg._chunked_decontam


@pytest.mark.cuda
def test_a_batch_of_8_tiles_runs_as_one_chunk(cuda):
    """ViT-B/16 at its widths on drawn weights, the production recipe:
    predict_batch_raw of 8 512x512 tiles runs one chunk of 128 crops, its
    probabilities within SERVE_TOL of chunks of 2 and every pixel decided
    by margin TAU given the same label; the chunk's peak allocation stays
    within the model's estimate plus a third (it under-estimates by at most
    25%)."""
    seg = SegmentorEx(clip_type="CLIP", vit_type="ViT-B/16", model_type="Experimental",
                      name_path=POTSDAM, ignore_residual=True,
                      global_debias_factor=0.2, apply_sim_feat_up=True,
                      sim_feat_up_cfg=dict(model_name="jbu_one", num_stages=2),
                      apply_outlier_suppression=True, outlier_suppression_cfg=dict(top_k=30),
                      apply_similarity_enhancement=True, device=cuda,
                      query_features=np.random.RandomState(1).randn(8, 512).astype(np.float32))
    images = np.random.RandomState(2).randint(0, 256, (8, 512, 512, 3), np.uint8)
    seg.predict_batch_raw(images)  # warm-up
    spans = _chunk_spans(seg, images)
    assert [(a["crops"], a["of"]) for a in spans] == [(128, 1)], spans
    assert spans[0]["peak_bytes"] == 128 * _per_crop(14, 512) <= spans[0]["budget"], spans
    got, peaks = _chunk_peak(seg, lambda: seg.predict_batch_raw(images))
    seg.tile_chunk = 2
    ref = seg.predict_batch_raw(images)
    est = 128 * _per_crop(14, 512)
    print(f"chunk of 128 crops: peak {peaks[0]} bytes, modelled {est} "
          f"(ratio {est / peaks[0]:.3f}) on {torch.cuda.get_device_name(cuda)}")
    assert len(peaks) == 1 and peaks[0] <= est / 0.75, (peaks, est)
    for a, b in zip(got, ref):
        err = (a["seg_logits"].float() - b["seg_logits"].float()).abs().max().item()
        top2 = b["seg_logits"].float().topk(2, dim=0).values
        decided = (top2[0] - top2[1]) >= TAU
        same = (a["pred_sem_seg"][0] == b["pred_sem_seg"][0])[decided].all().item()
        print(f"max|probs - chunks of 2| {err:.3e}, decided labels equal {same}")
        assert err <= SERVE_TOL and same, (err, same)


@pytest.mark.cuda
@pytest.mark.parametrize("width,grid,patch", [(512, 14, 16), (768, 16, 14)])
@pytest.mark.parametrize("upsampler", ["jbu_one", "jbu_stack"])
@pytest.mark.parametrize("stages", [1, 2, 4])
@pytest.mark.parametrize("route,dtype", [("nhwc_classify", BF16), ("nhwc", BF16),
                                         ("channel_first", BF16), ("channel_first", F32)])
def test_the_byte_model_holds_on_the_card(cuda, tmp_path, monkeypatch, width, grid, patch,
                                          upsampler, stages, route, dtype):
    """One chunk of 4 crops of 224 through ``_chunked_decontam`` at the
    width and grid of ViT-B/16 / ViT-L/14 on a one-block tower: the peak
    allocation above its start within the model's estimate less 25%."""
    monkeypatch.delenv("RS_OV_TILE_CHUNK", raising=False)
    seg = _segmentor(tmp_path, embed=width, device=cuda, param_dtype=dtype, tile_chunk=4,
                     clip_config=_cfg(width, patch),
                     sim_feat_up_cfg=dict(model_name=upsampler, num_stages=stages))
    monkeypatch.setattr(seg, "_jbu_route", lambda tokens: route)
    g = torch.Generator(device=cuda).manual_seed(0)
    crops, q = 4, seg.query_features.shape[0]
    tokens = torch.randn((crops, grid * grid, width), generator=g, device=cuda).to(dtype)
    cls_norm = torch.nn.functional.normalize(torch.randn((crops, width), generator=g,
                                                         device=cuda), dim=-1)
    tiles = torch.randn((crops, 3, 224, 224), generator=g, device=cuda).to(dtype)
    cls_logits = torch.zeros((crops, q), device=cuda)

    def call():
        return seg._chunked_decontam(tokens, cls_norm, cls_logits, tiles, (grid, grid),
                                     (0, 0, 0, 0), (224, 224))

    call()  # warm-up: the resize matrices, cuBLAS's workspace
    _, peaks = _chunk_peak(seg, call)
    taps = ONE if upsampler == "jbu_one" else STACK
    est = crops * chunk_peak_bytes((grid, grid), stages, route, width, taps, q, dtype,
                                   (224, 224))
    print(f"{route} {dtype} {upsampler} stages {stages} C {width}: peak {peaks[0] / crops:.0f} "
          f"bytes a crop, modelled {est / crops:.0f} (ratio {est / peaks[0]:.3f})")
    assert est >= 0.75 * peaks[0], (peaks[0], est)


@pytest.mark.cuda
def test_a_chunk_past_two_to_the_31_elements_equals_chunks_of_8(cuda, tmp_path, monkeypatch):
    """ViT-B/16's width and token grid at jbu_one's 4 stages, bf16 on the
    default route (nhwc_classify): one chunk of 79 crops, the most the
    card's budget takes, whose last stage's padded source [79, 234, 234,
    512] holds more than 2^31 elements, gives the logits of the same crops
    in chunks of 8 bit for bit; its peak allocation lies within 10% of the
    model's ``chunk_peak_bytes`` x 79."""
    monkeypatch.delenv("RS_OV_TILE_CHUNK", raising=False)
    crops, grid, width = 79, 14, 512
    assert crops * (16 * grid + 10) ** 2 * width > 2 ** 31
    seg = _segmentor(tmp_path, embed=width, device=cuda, param_dtype=BF16, tile_chunk=crops,
                     clip_config=_cfg(width, 16),
                     sim_feat_up_cfg=dict(model_name="jbu_one", num_stages=4))
    g = torch.Generator(device=cuda).manual_seed(0)
    q = seg.query_features.shape[0]
    tokens = torch.randn((crops, grid * grid, width), generator=g, device=cuda).to(BF16)
    cls_norm = torch.nn.functional.normalize(torch.randn((crops, width), generator=g,
                                                         device=cuda), dim=-1)
    tiles = torch.randn((crops, 3, 224, 224), generator=g, device=cuda).to(BF16)
    cls_logits = torch.zeros((crops, q), device=cuda)
    assert seg._jbu_route(tokens) == "nhwc_classify"

    def call():
        return seg._chunked_decontam(tokens, cls_norm, cls_logits, tiles, (grid, grid),
                                     (0, 0, 0, 0), (224, 224))

    call()  # warm-up
    got, peaks = _chunk_peak(seg, call)
    seg.tile_chunk = 8
    ref = call()
    est = crops * _per_crop(grid, width, stages=4, queries=q)
    diff = (got - ref).abs().max().item()
    print(f"79 crops at 4 stages: peak {peaks[0]} bytes, modelled {est} (ratio "
          f"{est / peaks[0]:.3f}); max|chunk of 79 - chunks of 8| {diff:.3e} on "
          f"{torch.cuda.get_device_name(cuda)}")
    assert got.shape == (crops, q, 224, 224) and torch.isfinite(got).all()
    assert torch.equal(got, ref), diff
    assert abs(peaks[0] - est) <= 0.1 * est, (peaks[0], est)
