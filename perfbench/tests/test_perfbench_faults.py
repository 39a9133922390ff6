"""A run of a cell with the timed path broken underneath comes out not
correct: the harness's whole run on the CPU (no look for a card) at tiny
widths, once for each fault a segmentation cell can have. An answer altered
where it is produced: the upsampler's features of one crop of every call
zeroed. Half of the batch left out: the calls answer the first half of
their images and repeat those answers for the rest, or return only them.
The other faults of the contract (a training step that returns its state
unchanged, the exchange between chips left out) have no place in these
one-card inference cells."""

import time

import pytest
import torch

from perfbench.harness import cell, program


def _broken(monkeypatch, fault):
    real = program.build

    def build(*args, **kwargs):
        seg = real(*args, **kwargs)
        fault(seg)
        return seg

    monkeypatch.setattr(program, "build", build)


def answer_altered(seg):
    up = seg._upsample_fn

    def zero_first_crop(params, source, guidance):
        out = up(params, source, guidance)
        out[0] = 0.0
        return out

    seg._upsample_fn = zero_first_crop


def half_batch_repeated(seg):
    call = seg.predict_batch_raw

    def predict(inputs):
        half = call(inputs[:len(inputs) // 2])
        return (half * 2)[:len(inputs)]

    seg.predict_batch_raw = predict


def half_batch_dropped(seg):
    call = seg.predict_batch_raw
    seg.predict_batch_raw = lambda inputs: call(inputs[:len(inputs) // 2])


def _run(tiny, variant, traffic):
    return cell.run(tiny(variant, traffic), 991, 0.3, False, torch.device("cpu"),
                    time.perf_counter())[0]


@pytest.mark.parametrize("variant", ["b16", "l14"])
@pytest.mark.parametrize("traffic", ["serve", "batch"])
def test_an_answer_altered_where_produced_is_not_correct(tiny, monkeypatch, variant, traffic):
    _broken(monkeypatch, answer_altered)
    result = _run(tiny, variant, traffic)
    assert result["failed"] == 0
    assert result["checks"]["prob_gap_mean"]["value"] > result["checks"]["prob_gap_mean"]["max"]
    assert not result["correct"]


@pytest.mark.parametrize("fault", [half_batch_repeated, half_batch_dropped])
def test_half_the_batch_left_out_is_not_correct(tiny, monkeypatch, fault):
    _broken(monkeypatch, fault)
    result = _run(tiny, "b16", "batch")
    assert not result["correct"]
    if fault is half_batch_dropped:
        assert result["failed"] == result["attempted"] > 0
