"""chip_smoke.py's phase 9 (phase_generate) rehearsed on the CPU at tiny
widths: BLIP's configs cut to a tiny tower at the phase's image sizes and a
62-word synthetic vocabulary, the two CoCa names resolved to tiny configs
(49408-token vocabularies, so generate's default start and end tokens
exist; a tiny RoBERTa for the HF-towered one), the card the CPU, CUDA timing
stubbed. Every gate passes and every planted fault lands on the wrong side
of its bound, as on the card."""

import dataclasses

import torch

from rs_ov_torch import factory
from rs_ov_torch.core import config
from rs_ov_torch.nn import hf_text
from rs_ov_torch.nn.bert import BertConfig
from rs_ov_torch.nn.blip import BlipConfig
from rs_ov_torch.nn.blip_vit import BlipVisionConfig

torch.set_num_threads(2)

TINY_COCA = config.CoCaConfig(
    embed_dim=16,
    vision=config.VisionConfig(image_size=32, patch_size=16, width=24, layers=2, output_dim=16,
                               head_width=12),
    text=config.TextConfig(context_length=32, vocab_size=49408, width=16, heads=2, layers=2,
                           output_dim=16, pool_type="last", embed_cls=True),
    multimodal=config.MultimodalConfig(context_length=32, vocab_size=49408, width=16, heads=2,
                                       layers=2),
    attn_pooler_queries=8, attn_pooler_heads=2)
TINY_ROBERTA = hf_text.HFTextConfig(model_type="roberta", vocab_size=50, hidden_size=32,
                                    num_layers=2, num_heads=2, intermediate_size=64,
                                    max_position_embeddings=40, pad_token_id=1, output_dim=16,
                                    pooler_type="mean_pooler", proj_type="linear")


class _Event:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def test_chip_smoke_phase_generate_rehearses_on_the_cpu(monkeypatch, capsys):
    import chip_smoke as cs

    def blip_cfg(size):
        return BlipConfig(vision=BlipVisionConfig(image_size=size, patch_size=32, width=24,
                                                  layers=2, heads=2),
                          text=BertConfig(vocab_size=64, hidden_size=16, num_layers=2,
                                          num_heads=2, intermediate_size=32,
                                          max_position_embeddings=40), embed_dim=8)

    coca_cfgs = {cs.GEN_COCA: TINY_COCA, cs.GEN_COCA_HF: dataclasses.replace(
        TINY_COCA, text=dataclasses.replace(TINY_COCA.text, width=32, embed_cls=False,
                                            hf_model_name="roberta-base",
                                            hf_proj_type="linear"),
        multimodal=dataclasses.replace(TINY_COCA.multimodal, width=32))}
    monkeypatch.setattr(cs, "_blip_gen_cfg", blip_cfg)
    monkeypatch.setattr(cs, "GEN_VOCAB", 62)
    monkeypatch.setattr(cs, "VQA_CANDIDATES", 16)
    monkeypatch.setattr(cs, "ITM_PAIRS", 4)
    monkeypatch.setattr(config, "get_coca_config", coca_cfgs.__getitem__)
    monkeypatch.setattr(factory, "get_coca_config", coca_cfgs.__getitem__)
    monkeypatch.setattr(hf_text, "hf_text_config",
                        lambda name, output_dim, proj_type=None: dataclasses.replace(
                            TINY_ROBERTA, output_dim=output_dim, proj_type=proj_type))
    real_resolve = factory.resolve_device
    monkeypatch.setattr(factory, "resolve_device",
                        lambda device=None: real_resolve("cpu" if device is None else device))
    monkeypatch.setattr(cs, "DEV", torch.device("cpu"))
    monkeypatch.setattr(cs, "_median_ms", lambda fn, reps=20: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setitem(cs.CARD, "smi", "CPU rehearsal")
    cs.phase_generate()
    out = capsys.readouterr().out
    for line in ("planted fault, parent gather skipped", "the cross K/V zeroed: agree False",
                 "the CLS put first", "decode golden beam_captions"):
        assert line in out, line
    from rs_ov_torch.nn import bert, blip_lm, coca

    # every fault undone
    assert blip_lm._gather_cache is bert.gather_cache and coca._gather_cache is bert.gather_cache
    assert coca.coca_encode_text.__name__ == "coca_encode_text"
    assert blip_lm.bert_decode_step is bert.bert_decode_step
