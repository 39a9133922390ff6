"""CLIP contrastive fine-tuning on the card (the counterpart of train.py).

    python -m rs_ov_torch.train --model ViT-B/16 --synthetic --steps 20 --batch-size 8
    python -m rs_ov_torch.train --tiny --synthetic --steps 2 --device cpu
    torchrun --standalone --nproc-per-node 4 -m rs_ov_torch.train --model ViT-B-32 --data pairs.tsv \\
        --steps 1000 --batch-size 256 --mesh 2,2 --precision bf16 --ckpt-dir work_dirs/ft

The step is ``train.step.make_clip_train_step`` (CLIP or SigLIP loss, bf16
compute over fp32 masters, remat, accumulation with full-batch negatives),
AdamW with optax's warmup-cosine schedule and the ndim >= 2 decay mask,
``.npz`` checkpoints and resume (``train.loop``). ``--mesh DP,TP`` lays the
ranks of ``torchrun`` out as ("data", "model"): each rank reads its rows of
every global batch, the CLIP blocks split over "model". ``--data``: a
``.tsv`` / ``.csv`` / ``.jsonl`` manifest of (image path, caption) pairs, or
a directory where each image has a same-stem ``.txt`` caption;
``--synthetic``: random batches. ``--device`` defaults to the card
(``cuda:LOCAL_RANK``), and without one the run raises; ``--device cpu``
runs on the CPU (gloo between ranks). The last line is the last logged
step as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="ViT-B/16",
                    help="arch name (any core/config.py registry entry)")
    ap.add_argument("--pretrained", default=None,
                    help="checkpoint path to start from (else random init)")
    ap.add_argument("--data", default=None,
                    help="manifest file (.tsv/.csv/.jsonl) or sidecar dir")
    ap.add_argument("--synthetic", action="store_true",
                    help="random image/text batches (smoke / throughput)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--wd", type=float, default=0.2)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--loss", choices=("clip", "siglip"), default="clip")
    ap.add_argument("--grad-clip-norm", type=float, default=None,
                    help="clip raw gradients to this global L2 norm before "
                         "the optimizer step (open_clip --grad-clip-norm)")
    ap.add_argument("--accum-freq", type=int, default=1,
                    help="gradient accumulation with full-batch negatives: "
                         "--batch-size is the GLOBAL batch, split into this "
                         "many micro-batches per optimizer step")
    ap.add_argument("--precision", choices=("fp32", "bf16"), default="bf16")
    ap.add_argument("--mesh", default="",
                    help="'DP,TP' mesh shape (default: all ranks on data)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="shrink the arch to a debug size (smoke tests)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: cuda:LOCAL_RANK) or 'cpu'")
    return ap.parse_args(argv)


def read_manifest(path: str) -> list[tuple[str, str]]:
    """(image path, caption) pairs of a .tsv / .csv / .jsonl manifest or a
    directory of images with same-stem .txt captions (train.py:68-97)."""
    pairs: list[tuple[str, str]] = []
    if os.path.isdir(path):
        for fn in sorted(os.listdir(path)):
            stem, ext = os.path.splitext(fn)
            if ext.lower() in (".jpg", ".jpeg", ".png", ".tif", ".tiff"):
                cap = os.path.join(path, stem + ".txt")
                if os.path.exists(cap):
                    with open(cap) as f:
                        pairs.append((os.path.join(path, fn), f.read().strip()))
        return pairs
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if path.endswith(".jsonl"):
                d = json.loads(line)
                pairs.append((d["image"], d["caption"]))
            else:
                # delimiter by extension; unknown extensions prefer tab
                sep = ("\t" if path.endswith(".tsv")
                       else "," if path.endswith(".csv")
                       else "\t" if "\t" in line else ",")
                img, cap = line.split(sep, 1)
                pairs.append((img, cap))
    return pairs


def data_iter(args, image_size: int, context_length: int, rng: np.random.RandomState,
              rows: slice = slice(None)):
    """(images [b, 3, S, S] fp32, tokens [b, L] int32) host batches: ``rows``
    of each global batch of --batch-size (this rank's under a mesh)."""
    b = args.batch_size
    if args.synthetic:
        toks = rng.randint(1, 1000, size=(b, context_length)).astype(np.int32)
        while True:
            yield (rng.randn(b, 3, image_size, image_size).astype(np.float32)[rows],
                   toks[rows])
    from rs_ov_torch.data.transforms import load_image
    from rs_ov_torch.factory import image_transform
    from rs_ov_torch.text.tokenizer import tokenize

    pairs = read_manifest(args.data)
    if not pairs:
        sys.exit(f"no (image, caption) pairs found in {args.data}")
    print(f"[train] {len(pairs)} image-text pairs", flush=True)
    preprocess = image_transform(image_size)
    order = rng.permutation(len(pairs))
    i = 0
    while True:
        picked = []
        for _ in range(b):
            if i == len(order):
                order = rng.permutation(len(pairs))
                i = 0
            picked.append(pairs[order[i]])
            i += 1
        picked = picked[rows]
        yield (np.stack([preprocess(load_image(p)) for p, _ in picked]),
               np.asarray(tokenize([c for _, c in picked], context_length), np.int32))


def _tiny(cfg):
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, image_size=32, width=64, layers=2,
                                   output_dim=cfg.embed_dim),
        text=dataclasses.replace(cfg.text, width=64, heads=1, layers=2, context_length=16,
                                 output_dim=cfg.embed_dim))


def setup_mesh(mesh_arg: str, device_arg):
    """(device, mesh or None, data rank, data size) from --mesh, --device and
    torchrun's environment; a process group only where there are ranks."""
    from rs_ov_torch.factory import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    dp, tp = (int(x) for x in mesh_arg.split(",")) if mesh_arg else (world, 1)
    if dp * tp != world:
        sys.exit(f"mesh {dp}x{tp} needs {dp * tp} ranks, have {world} (run under "
                 f"torchrun --standalone --nproc-per-node {dp * tp})")
    device = resolve_device(device_arg)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if world == 1:
        return device, None, 0, 1
    from rs_ov_torch.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(device=device)
    mesh = make_mesh(dp, tp, device_type=device.type)
    return device, mesh, mesh.get_local_rank("data"), dp


def main(argv=None):
    args = parse_args(argv)
    if not args.synthetic and not args.data:
        sys.exit("pass --data <manifest-or-dir> or --synthetic")

    from rs_ov_torch.core.checkpoint import clip_params_from_state_dict, load_torch_state_dict
    from rs_ov_torch.core.config import get_model_config
    from rs_ov_torch.core.params import init_clip_params, load_numpy_tree
    from rs_ov_torch.parallel import sharding
    from rs_ov_torch.train import optim
    from rs_ov_torch.train.loop import train_loop
    from rs_ov_torch.train.step import make_clip_train_step

    device, mesh, data_rank, dp = setup_mesh(args.mesh, args.device)
    writer = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0
    tp = 1 if mesh is None else mesh.size(1)
    if writer:
        print(f"[train] mesh data={dp} model={tp} ({device})", flush=True)

    cfg = get_model_config(args.model)
    if cfg.vision.timm_model_name or cfg.text.hf_model_name:
        sys.exit(f"{args.model}: the train step covers the classic CLIP ViT+text "
                 "towers (train/step.py)")
    if args.tiny:
        cfg = _tiny(cfg)
    if args.batch_size % dp:
        sys.exit(f"batch size {args.batch_size} not divisible by data={dp}")
    if (args.batch_size // dp) % args.accum_freq:
        sys.exit(f"--accum-freq {args.accum_freq} must divide the batch of each data "
                 f"rank ({args.batch_size // dp})")

    if args.pretrained:
        params = clip_params_from_state_dict(load_torch_state_dict(args.pretrained))
        print(f"[train] loaded {args.pretrained}", flush=True)
    else:
        params = init_clip_params(torch.Generator().manual_seed(args.seed), cfg)
    bias0 = float(cfg.init_logit_bias if cfg.init_logit_bias is not None else -10.0)
    if args.loss == "siglip" and not hasattr(params, "logit_bias"):
        params.logit_bias = torch.nn.Parameter(torch.tensor(bias0), requires_grad=False)
    params = params.requires_grad_().to(device)

    def from_tree(p, tree):
        # a clip-loss checkpoint has no bias leaf: SigLIP starts it anew
        if args.loss == "siglip" and "logit_bias" not in tree:
            tree = {**tree, "logit_bias": np.float32(bias0)}
        return load_numpy_tree(p, tree) if tp == 1 else sharding.load_sharded(p, tree, mesh)

    to_tree = None
    if tp > 1:
        params = sharding.shard_params(params, mesh)
        to_tree = lambda p: sharding.gather_params(p, mesh)  # noqa: E731

    schedule = optim.warmup_cosine_decay_schedule(
        0.0, args.lr, optim.warmup_steps(args.warmup, args.steps), args.steps)
    optimizer = optim.adamw(schedule, weight_decay=args.wd, mask=optim.decay_matrices,
                            clip_norm=args.grad_clip_norm)
    step_fn, init_opt = make_clip_train_step(
        cfg, mesh, optimizer=optimizer,
        compute_dtype=torch.bfloat16 if args.precision == "bf16" else None,
        loss=args.loss, accum_steps=args.accum_freq)
    opt = init_opt(params)

    b = args.batch_size // dp
    rng = np.random.RandomState(args.seed)
    it = data_iter(args, cfg.vision.image_size, cfg.text.context_length, rng,
                   slice(data_rank * b, (data_rank + 1) * b))
    params, opt, history = train_loop(
        step_fn, params, opt, it, args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=args.log_every, resume=not args.no_resume,
        to_tree=to_tree, from_tree=from_tree, writer=writer)
    if history and writer:
        print(json.dumps(history[-1]), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return params


if __name__ == "__main__":
    main()
