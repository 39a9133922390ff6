"""BLIP training on the card (the counterpart of train_blip.py).

    python -m rs_ov_torch.train_blip --task pretrain --tiny --synthetic --steps 4 \\
        --batch-size 8 --device cpu
    torchrun --standalone --nproc-per-node 4 -m rs_ov_torch.train_blip --task retrieval \\
        --data pairs.tsv --vocab vocab.txt --steps 1000 --batch-size 64 --mesh 4,1

Tasks:
  retrieval  ITC (momentum encoders + feature queue) + hard-negative ITM
             (train.blip_retrieval)
  pretrain   retrieval + caption LM through the weight-tied decoder
             (train.blip_pretrain)
  caption    image-conditioned LM loss (nn.blip_lm.blip_caption_loss)
  vqa        question-grounded answer LM loss (nn.blip_lm.blip_vqa_loss)
  nlvr       two-image entailment CE (nn.blip_lm.blip_nlvr_forward)

``--data`` is a manifest of (image, caption) pairs (train.py's formats) for
retrieval / pretrain / caption, with ``--vocab`` a BERT vocab.txt;
``--synthetic`` trains every task on random batches. ``--augment`` runs
RandomAugment(2, 5) on the manifest's images. The soft-target weight ramps
as alpha * min(1, (step + 1) / warmup). ``--evaluate`` runs the retrieval
evaluation (ITC shortlist, ITM rerank, recall@K) instead of training.
``--mesh DP,1`` under ``torchrun`` trains data-parallel with whole leaves.
``--device`` defaults to the card (``cuda:LOCAL_RANK``); ``--device cpu``
runs on the CPU. Each logged step prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

TASKS = ("retrieval", "pretrain", "caption", "vqa", "nlvr")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", choices=TASKS, default="retrieval")
    ap.add_argument("--vit", choices=("base", "large"), default="base",
                    help="BLIP vision tower size (reference create_vit)")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--pretrained", default=None,
                    help="BLIP .pth checkpoint to start from")
    ap.add_argument("--data", default=None,
                    help="(image, caption) manifest - see train.py formats")
    ap.add_argument("--vocab", default=None,
                    help="BERT vocab.txt for WordPiece tokenization")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--augment", action="store_true",
                    help="RandomAugment(2, 5) on manifest images (the reference "
                         "BLIP train pipelines' transform)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--context-length", type=int, default=30)
    ap.add_argument("--queue-size", type=int, default=None,
                    help="retrieval/pretrain feature queue (default 16x batch; "
                         "reference 57600)")
    ap.add_argument("--alpha", type=float, default=0.4,
                    help="soft-target momentum-distillation weight, ramped over "
                         "--warmup steps (reference train scripts)")
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--wd", type=float, default=0.05)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--precision", choices=("fp32", "bf16"), default="bf16")
    ap.add_argument("--mesh", default="",
                    help="'DP,TP' mesh shape (TP must be 1: BLIP is data-parallel)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--evaluate", action="store_true",
                    help="retrieval only: skip training and run the ITC->ITM rerank "
                         "evaluation + recall@K")
    ap.add_argument("--k-test", type=int, default=16,
                    help="ITM rerank shortlist size (reference k_test)")
    ap.add_argument("--eval-samples", type=int, default=64,
                    help="--evaluate set size (manifest rows or synthetic)")
    ap.add_argument("--tiny", action="store_true",
                    help="shrink the arch to a debug size (smoke tests)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: cuda:LOCAL_RANK) or 'cpu'")
    return ap.parse_args(argv)


def blip_cfg(args):
    from rs_ov_torch.nn.bert import BertConfig
    from rs_ov_torch.nn.blip import BlipConfig

    cfg = (BlipConfig.large(args.image_size) if args.vit == "large"
           else BlipConfig.base(args.image_size))
    if args.tiny:
        cfg = BlipConfig(
            vision=dataclasses.replace(cfg.vision, image_size=32, patch_size=16, width=64,
                                       layers=2, heads=2),
            text=BertConfig(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
                            intermediate_size=128, max_position_embeddings=32),
            embed_dim=32)
    return cfg


def _tokenizer(args):
    if args.vocab:
        from rs_ov_torch.text.wordpiece import WordPieceTokenizer

        return WordPieceTokenizer(args.vocab)
    sys.exit("--data needs --vocab <bert vocab.txt> for tokenization")


def special_token_ids(args):
    """(bos, enc): literals for the synthetic path (stand-ins inside the tiny
    vocabulary, or bert-base's 30522 + [DEC] / [ENC]); a --data run takes
    them from its own vocabulary."""
    if args.synthetic:
        return (2, 3) if args.tiny else (30522, 30523)
    tok = _tokenizer(args)
    return tok.bos_token_id, tok.enc_token_id


def synth_batches(args, cfg, rng):
    """Random host batches shaped per task (train_blip.py:122-151)."""
    b, s, ln = args.batch_size, cfg.vision.image_size, args.context_length
    v = cfg.text.vocab_size
    bos, enc = 2, 3  # stand-ins within the tiny vocab
    step = 0
    while True:
        imgs = rng.randn(b, 3, s, s).astype(np.float32)
        ids = rng.randint(4, v, size=(b, ln)).astype(np.int32)
        mask = np.ones((b, ln), np.int32)
        if args.task in ("retrieval", "pretrain"):
            yield {"images": imgs, "ids": ids, "mask": mask,
                   "idx": (np.arange(b) + step * b).astype(np.int32)}
        elif args.task == "caption":
            ids[:, 0] = bos
            yield {"images": imgs, "ids": ids, "mask": mask}
        elif args.task == "vqa":
            a_ids = rng.randint(4, v, size=(b, ln)).astype(np.int32)
            a_ids[:, 0] = bos
            ids[:, 0] = enc
            yield {"images": imgs, "ids": ids, "mask": mask, "a_ids": a_ids,
                   "a_mask": mask.copy(), "a2q": np.arange(b, dtype=np.int32),
                   "w": np.ones((b,), np.float32)}
        else:  # nlvr: two scenes per text
            ids[:, 0] = enc
            yield {"images": rng.randn(2 * b, 3, s, s).astype(np.float32), "ids": ids,
                   "mask": mask, "targets": rng.randint(0, 2, size=(b,)).astype(np.int32)}
        step += 1


def pair_batches(args, cfg, rng):
    """(image, caption) manifest batches for retrieval / pretrain / caption
    (train_blip.py:154-212): RGB / 255, a bicubic resize to the tower's
    size, CLIP's mean and std."""
    from rs_ov_torch.data.transforms import load_image
    from rs_ov_torch.train.__main__ import read_manifest
    from rs_ov_torch.utils.resize import resize_bicubic

    tok = _tokenizer(args)
    pairs = read_manifest(args.data)
    if not pairs:
        sys.exit(f"no (image, caption) pairs in {args.data}")
    print(f"[train_blip] {len(pairs)} image-text pairs", flush=True)
    aug = None
    if args.augment:
        from rs_ov_torch.data.randaugment import RandomAugment

        aug = RandomAugment(2, 5, isPIL=True,
                            augs=["Identity", "AutoContrast", "Brightness", "Sharpness",
                                  "Equalize", "ShearX", "ShearY", "TranslateX", "TranslateY",
                                  "Rotate"], seed=args.seed)
    mean = np.asarray((0.48145466, 0.4578275, 0.40821073), np.float32)
    std = np.asarray((0.26862954, 0.26130258, 0.27577711), np.float32)
    s, b = cfg.vision.image_size, args.batch_size
    order = rng.permutation(len(pairs))
    i = 0
    while True:
        imgs, caps, gids = [], [], []
        for _ in range(b):
            gid = int(order[i])
            img_path, cap = pairs[gid]
            raw = load_image(img_path)
            if aug is not None:
                raw = aug(raw)
            x = np.asarray(raw, np.float32) / 255.0
            x = resize_bicubic(torch.from_numpy(x.transpose(2, 0, 1).copy()), (s, s)).numpy()
            imgs.append((x - mean[:, None, None]) / std[:, None, None])
            caps.append(cap)
            gids.append(gid)
            i += 1
            if i == len(pairs):
                order = rng.permutation(len(pairs))
                i = 0
        t = tok(caps, max_length=args.context_length)
        batch = {"images": np.stack(imgs), "ids": t["input_ids"], "mask": t["attention_mask"],
                 "idx": np.asarray(gids, np.int32)}
        if args.task == "caption":
            batch["ids"] = batch["ids"].copy()
            batch["ids"][:, 0] = tok.bos_token_id
            del batch["idx"]
        yield batch


def run_retrieval_eval(args, cfg, params, rng):
    """train_retrieval.py --evaluate: the evaluation, ITM rerank and recall@K
    on synthetic pairs or the manifest (i-th image <-> i-th caption)."""
    from rs_ov_torch.evalsuite.retrieval import blip_retrieval_evaluation

    n = max(args.eval_samples, args.k_test)
    if args.synthetic:
        s = cfg.vision.image_size
        images = rng.randn(n, 3, s, s).astype(np.float32)
        ids = rng.randint(4, cfg.text.vocab_size, (n, args.context_length)).astype(np.int32)
        mask = np.ones_like(ids)
    else:
        imgs, idss, masks, got = [], [], [], 0
        for batch in pair_batches(args, cfg, rng):
            imgs.append(batch["images"])
            idss.append(batch["ids"])
            masks.append(batch["mask"])
            got += len(batch["images"])
            if got >= n:
                break
        images = np.concatenate(imgs)[:n]
        ids = np.concatenate(idss)[:n].astype(np.int32)
        mask = np.concatenate(masks)[:n].astype(np.int32)
    m = blip_retrieval_evaluation(
        params, cfg, images, ids, mask, special_token_ids(args)[1],
        txt2img=list(range(len(images))), img2txt=[[i] for i in range(len(images))],
        k_test=args.k_test, log=lambda s: print(f"[eval] {s}", flush=True))
    print(json.dumps({k: round(v, 3) for k, v in m.items()}))
    return m


def _state_to(state, device):
    state["params"].to(device)
    state["params_m"].to(device)
    state["queue"] = {k: v.to(device) for k, v in state["queue"].items()}
    return state


def main(argv=None):
    args = parse_args(argv)
    if not args.synthetic and not args.data:
        sys.exit("pass --data <manifest-or-dir> or --synthetic")
    if args.evaluate and args.task != "retrieval":
        sys.exit("--evaluate is the retrieval-task eval mode")
    if args.data and args.task in ("vqa", "nlvr"):
        sys.exit(f"--data for {args.task} needs task-specific annotation formats; use "
                 "--synthetic (smoke) or the library API")

    from rs_ov_torch.core.checkpoint import load_torch_state_dict, save_pytree
    from rs_ov_torch.core.params import cast_floating
    from rs_ov_torch.nn import blip_lm
    from rs_ov_torch.nn.blip import blip_params_from_state_dict
    from rs_ov_torch.parallel.collectives import mean_over, mean_share
    from rs_ov_torch.parallel.mesh import mesh_groups
    from rs_ov_torch.train import optim
    from rs_ov_torch.train.__main__ import setup_mesh
    from rs_ov_torch.train.step import reduce_grads

    if args.mesh and args.mesh.split(",")[1:] not in ([], ["1"]):
        sys.exit("BLIP trains data-parallel with whole leaves: --mesh DP,1")
    device, mesh, data_rank, dp = setup_mesh(args.mesh, args.device)
    group, _ = mesh_groups(mesh)
    writer = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0
    if writer:
        print(f"[train_blip] task={args.task} mesh data={dp} model=1 ({device})", flush=True)
    if args.batch_size % dp:
        sys.exit(f"batch size {args.batch_size} not divisible by data={dp}")

    cfg = blip_cfg(args)
    cdtype = torch.bfloat16 if args.precision == "bf16" else None
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, args.lr, optim.warmup_steps(args.warmup, args.steps), args.steps)
    optimizer = optim.adamw(schedule, weight_decay=args.wd, mask=optim.decay_matrices)
    gen = torch.Generator().manual_seed(args.seed)
    rng = np.random.RandomState(args.seed)
    q = args.queue_size or 16 * args.batch_size
    b = args.batch_size // dp
    mine = slice(data_rank * b, (data_rank + 1) * b)

    if args.task in ("retrieval", "pretrain"):
        bos_id, enc_id = special_token_ids(args)
        if args.task == "retrieval":
            from rs_ov_torch.train.blip_retrieval import (init_blip_retrieval_state,
                                                          make_blip_retrieval_train_step)

            state = init_blip_retrieval_state(gen, cfg, queue_size=q)
            step_fn, init_opt = make_blip_retrieval_train_step(
                cfg, mesh, optimizer=optimizer, compute_dtype=cdtype, enc_token_id=enc_id)
            names = ("loss_ita", "loss_itm")
        else:
            from rs_ov_torch.train.blip_pretrain import (init_blip_pretrain_state,
                                                         make_blip_pretrain_train_step)

            state = init_blip_pretrain_state(gen, cfg, queue_size=q)
            step_fn, init_opt = make_blip_pretrain_train_step(
                cfg, mesh, optimizer=optimizer, compute_dtype=cdtype, enc_token_id=enc_id,
                bos_token_id=bos_id)
            names = ("loss_ita", "loss_itm", "loss_lm")
        if args.pretrained:
            state["params"].load_state_dict(
                blip_params_from_state_dict(load_torch_state_dict(args.pretrained)).state_dict(),
                strict=False)
        state = _state_to(state, device)
        if args.evaluate:
            return run_retrieval_eval(args, cfg, state["params"], rng)
        opt = init_opt(state["params"])
        sample_gen = torch.Generator(device=device).manual_seed(args.seed + 1 + data_rank)

        def run_step(i, batch):
            nonlocal state, opt
            alpha = args.alpha * min(1.0, (i + 1) / max(args.warmup, 1))
            state, opt, losses = step_fn(state, opt, batch["images"][mine], batch["ids"][mine],
                                         batch["mask"][mine], batch["idx"][mine], alpha,
                                         sample_gen)
            return dict(zip(names, (float(x) for x in losses)))

        def to_save():
            return state
    else:
        init = {"caption": blip_lm.init_blip_decoder_params, "vqa": blip_lm.init_blip_vqa_params,
                "nlvr": blip_lm.init_blip_nlvr_params}[args.task]
        params = init(gen, cfg).requires_grad_().to(device)
        opt = optimizer.init(params)

        def loss_fn(p, batch):
            if cdtype is not None:
                p = cast_floating(p, cdtype)
            if args.task == "caption":
                # the global batch's token mean, as this rank's share
                ids = torch.as_tensor(batch["ids"]).to(device).long()
                per_seq = blip_lm.blip_caption_loss(p, batch["images"], ids, batch["mask"], cfg,
                                                    reduction="none")
                kept = (blip_lm.caption_targets(ids, 0, 4)[:, 1:] != blip_lm.IGNORE_INDEX).sum()
                return mean_share(per_seq.sum(), kept, group)
            if args.task == "vqa":
                return blip_lm.blip_vqa_loss(p, batch["images"], batch["ids"], batch["mask"],
                                             batch["a_ids"], batch["a_mask"], batch["a2q"],
                                             batch["w"], cfg)
            return blip_lm.blip_nlvr_forward(p, batch["images"], batch["ids"], batch["mask"],
                                             cfg, targets=batch["targets"])

        def run_step(i, batch):
            if args.task == "nlvr":  # the two scenes of this rank's rows
                n = args.batch_size
                imgs = batch["images"]
                batch = {**{k: v[mine] for k, v in batch.items() if k != "images"},
                         "images": np.concatenate([imgs[:n][mine], imgs[n:][mine]])}
            elif args.task == "vqa":  # this rank's questions and their answers
                batch = {k: v[mine] for k, v in batch.items()}
                batch["a2q"] = batch["a2q"] - mine.start
            else:
                batch = {k: v[mine] for k, v in batch.items()}
            opt.zero_grad()
            loss = loss_fn(params, batch)
            loss.backward()
            reduce_grads(params, group)
            opt.step()
            return {"loss": float(mean_over(loss, group))}

        def to_save():
            return params

    it = synth_batches(args, cfg, rng) if args.synthetic else pair_batches(args, cfg, rng)
    t0 = time.perf_counter()
    last = {}
    for i, batch in enumerate(it):
        if i >= args.steps:
            break
        last = run_step(i, batch)
        if writer and ((i + 1) % args.log_every == 0 or i + 1 == args.steps):
            rate = args.batch_size * (i + 1) / (time.perf_counter() - t0)
            print(json.dumps({"step": i + 1, **{k: round(v, 4) for k, v in last.items()},
                              "ex_per_sec": round(rate, 1)}), flush=True)
        if writer and args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            os.makedirs(args.ckpt_dir, exist_ok=True)
            save_pytree(to_save(), os.path.join(args.ckpt_dir, f"step_{i + 1:07d}.npz"))
    if writer and args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        save_pytree(to_save(), os.path.join(args.ckpt_dir, "final.npz"))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return last


if __name__ == "__main__":
    main()
