"""The system under test: ``rs_ov_torch``'s ``SegmentorEx``, built from the
benchmark's weights through the program's own checkpoint entries. The only
module of the benchmark that imports the program.

The CLIP tower goes in as the program's ``params`` tree, made by the
program's public converters from the public state dict: the same code
``checkpoint_path`` runs after ``torch.load``, without writing the tower to
disk each run (0.3 GB for ViT-B/16, 0.9 GB for ViT-L/14 with the text
tower). The upsampler goes through ``sim_feat_up_cfg["model_path"]``: a
``{"state_dict": ...}`` file of about a megabyte under the run's temporary
directory, read by the program's checkpoint loader.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from perfbench.harness import inputs, spec


def build(config: dict, host: dict, queries: np.ndarray, vocab_path: str, device, tmpdir: str):
    """``SegmentorEx`` on ``device`` from ``host`` ({public name: fp32
    array}, the vision tower and the upsampler) and the query embeddings."""
    import rs_ov_torch
    from rs_ov_torch.core.checkpoint import (text_params_from_state_dict,
                                             vision_params_from_state_dict)
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    if not os.path.abspath(rs_ov_torch.__file__).startswith(spec.REPO + os.sep):
        raise RuntimeError(f"the program must come from this checkout ({spec.REPO}), "
                           f"not {rs_ov_torch.__file__}")

    text = {name: np.broadcast_to(np.float32(0.0), shape)
            for name, shape in inputs.text_leaves(config)}
    tree = {"visual": vision_params_from_state_dict(host, "visual."),
            "text": text_params_from_state_dict(text, ""),
            "logit_scale": np.float32(np.log(1 / 0.07))}
    jbu_path = os.path.join(tmpdir, "jbu_one.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in host.items() if k.startswith("upsampler.")}},
               jbu_path)
    recipe = dict(config["recipe"])
    recipe["sim_feat_up_cfg"] = {**recipe["sim_feat_up_cfg"], "model_path": jbu_path}
    prog = config["program"]
    seg = SegmentorEx(clip_type=prog["clip_type"], vit_type=prog["vit_type"],
                      name_path=vocab_path, params=tree, query_features=queries,
                      param_dtype=getattr(torch, config["dtype"]), device=device, **recipe)
    os.remove(jbu_path)
    return seg
