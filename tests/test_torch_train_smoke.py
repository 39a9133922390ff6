"""chip_smoke.py's phase 10 (phase_train) rehearsed on the CPU at tiny widths:
the CLIP, BLIP and CoCa configs of the phase cut to tiny ones under the
phase's functions, the card the CPU (gloo in place of NCCL), CUDA timing and
memory stubbed, small batches and queue. Every gate passes and every
planted fault lands on the wrong side of its bound, as on the card."""

import torch

from rs_ov_torch.core import config
from rs_ov_torch.nn.bert import BertConfig
from rs_ov_torch.nn.blip import BlipConfig
from rs_ov_torch.nn.blip_vit import BlipVisionConfig
from test_torch_generate_smoke import TINY_COCA

torch.set_num_threads(2)

TINY_CLIP = config.CLIPConfig(
    embed_dim=16,
    vision=config.VisionConfig(image_size=32, patch_size=16, width=32, layers=2, output_dim=16,
                               head_width=8),
    text=config.TextConfig(context_length=12, vocab_size=64, width=32, heads=4, layers=2,
                           output_dim=16))
TINY_BLIP = BlipConfig(vision=BlipVisionConfig(image_size=32, patch_size=16, width=24, layers=2,
                                               heads=2),
                       text=BertConfig(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
                                       intermediate_size=32, max_position_embeddings=40),
                       embed_dim=8)


def test_chip_smoke_phase_train_rehearses_on_the_cpu(monkeypatch, capsys):
    import chip_smoke as cs

    monkeypatch.setattr(cs, "_train_clip_cfg", lambda: TINY_CLIP)
    monkeypatch.setattr(cs, "_train_coca_cfg", lambda: TINY_COCA)
    monkeypatch.setattr(cs, "_train_blip_cfg", lambda: TINY_BLIP)
    monkeypatch.setattr(cs, "TRAIN_QUEUE", 32)
    monkeypatch.setattr(cs, "RATE_BATCH", 8)
    monkeypatch.setattr(cs, "BLIP_RATE_BATCH", 8)
    monkeypatch.setattr(cs, "RATE_STEPS", 1)
    monkeypatch.setattr(cs, "DEV", torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setitem(cs.CARD, "smi", "CPU rehearsal")
    cs.phase_train()
    out = capsys.readouterr().out
    for line in ("(a) worst group", "(b) worst group", "(c) worst group",
                 "(d) least group cosine", "(f) worst group", "BLIP pretrain step queue columns",
                 "BLIP card vs CPU worst group", "rate: BLIP base retrieval step"):
        assert line in out, line
    assert out.count("planted fault") == 3 and "PASSES" not in out
    from rs_ov_torch.nn import layers
    from rs_ov_torch.train import blip_retrieval, step

    # every fault undone
    assert step._scale_live(1) is False
    assert layers._matmul32_grads.__name__ == "_matmul32_grads"
    assert blip_retrieval._ema_update.__name__ == "_ema_update"
    assert not torch.distributed.is_initialized()
