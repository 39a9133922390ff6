"""chip_smoke.py's phase 5 gate on the pixels the reference run decides
(``decided_agreement`` and ``pair_passes``), on synthetic class
probabilities made with numpy from a seed."""

import math

import numpy as np
import pytest
import torch

import chip_smoke as cs


def _probs(top_margin, h=20, w=20, classes=6, seed=0):
    """[classes, H, W] probabilities whose top-1 minus top-2 is top_margin
    ([H, W]) at every pixel, class 0 on top; the labels of that argmax."""
    rng = np.random.RandomState(seed)
    rest = rng.uniform(0.0, 0.05, (classes - 2, h, w))
    second = 0.3 + rng.uniform(0.0, 0.05, (h, w))
    p = np.concatenate([(second + top_margin)[None], second[None], rest]).astype(np.float32)
    return torch.from_numpy(p), torch.zeros(1, h, w, dtype=torch.int32)


def test_a_tie_below_the_margin_is_not_counted():
    """A flipped pixel whose reference margin is under TAU leaves the
    decided agreement at 1; the all-pixel agreement sees it."""
    margin = np.full((20, 20), 0.2)
    margin[3, 4] = cs.TAU / 2
    probs, ref = _probs(margin)
    pred = ref.clone()
    pred[0, 3, 4] = 1
    agree, decided, share = cs.decided_agreement(pred, ref, probs, cs.TAU)
    assert agree == pytest.approx(1 - 1 / 400) and decided == 1.0
    assert share == pytest.approx(1 - 1 / 400)
    assert cs.pair_passes(0.95, agree, decided, share)


def test_a_flipped_decided_pixel_fails():
    """One flip among 400 decided pixels: 0.9975 < 0.999 fails a 0.95 or
    0.99 pair, whose all-pixel agreement would have passed."""
    probs, ref = _probs(np.full((20, 20), 0.2))
    pred = ref.clone()
    pred[0, 7, 7] = 2
    agree, decided, share = cs.decided_agreement(pred, ref, probs, cs.TAU)
    assert decided == pytest.approx(1 - 1 / 400) and share == 1.0
    for need in (0.95, 0.99):
        assert agree >= need and not cs.pair_passes(need, agree, decided, share)


def test_a_share_under_half_fails():
    """Full agreement on too few decided pixels fails; at half it passes."""
    margin = np.full((20, 20), cs.TAU / 10)
    margin[:8] = 0.2  # 40% decided
    probs, ref = _probs(margin)
    agree, decided, share = cs.decided_agreement(ref.clone(), ref, probs, cs.TAU)
    assert decided == 1.0 and share == pytest.approx(0.4)
    assert not cs.pair_passes(0.95, agree, decided, share)
    margin[:10] = 0.2
    probs, ref = _probs(margin)
    assert cs.pair_passes(0.95, *cs.decided_agreement(ref.clone(), ref, probs, cs.TAU))


def test_no_decided_pixel_fails():
    probs, ref = _probs(np.zeros((20, 20)))
    agree, decided, share = cs.decided_agreement(ref.clone(), ref, probs, cs.TAU)
    assert agree == 1.0 and math.isnan(decided) and share == 0.0
    assert not cs.pair_passes(0.95, agree, decided, share)


def test_the_strict_pairs_keep_their_all_pixel_gate():
    """A 0.999 pair is held on every pixel, ties included."""
    margin = np.full((20, 20), 0.2)
    margin[0, :2] = 0.0
    probs, ref = _probs(margin)
    pred = ref.clone()
    pred[0, 0, :2] = 1
    agree, decided, share = cs.decided_agreement(pred, ref, probs, cs.TAU)
    assert decided == 1.0 and not cs.pair_passes(0.999, agree, decided, share)
    assert cs.pair_passes(0.99, agree, decided, share)


def test_the_pairs_and_the_margin():
    """TAU is one of the calibrated candidates; every pair names two runs
    and one of the three bounds, its reference second."""
    assert cs.TAU in cs.TAUS and cs.TAUS == tuple(sorted(cs.TAUS))
    assert {need for _, _, need in cs.E2E_PAIRS} == {0.95, 0.99, 0.999}
    strict = [(a, b) for a, b, need in cs.E2E_PAIRS if need == 0.999]
    assert ("fp32 channel-first", "fp32 CPU") in strict and len(strict) == 5
