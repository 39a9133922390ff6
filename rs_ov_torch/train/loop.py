"""The training loop with ``.npz`` checkpoints and resume (rs_ov/train/loop.py).

Every ``ckpt_every`` steps and at the end the params are written as
``step_<n>.npz`` (``core.checkpoint.save_pytree``); a run resumes from the
newest one. Only the params are saved, as in the JAX package, so the
optimiser (its moments and its schedule's count) starts over on resume.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterator, Optional

from rs_ov_torch.core.checkpoint import load_pytree, save_pytree
from rs_ov_torch.core.params import load_numpy_tree

__all__ = ["train_loop", "latest_checkpoint"]


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = [f for f in os.listdir(ckpt_dir) if f.startswith("step_") and f.endswith(".npz")]
    if not ckpts:
        return None
    return os.path.join(ckpt_dir, max(ckpts, key=lambda f: int(f[5:-4])))


def train_loop(step_fn: Callable, params, opt_state, data_iter: Iterator, num_steps: int, *,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 1000, log_every: int = 50,
               resume: bool = True, to_tree: Callable | None = None,
               from_tree: Callable | None = None, writer: bool = True):
    """Run ``num_steps`` of ``step_fn(params, opt_state, images, texts)``
    over ``data_iter``'s (images, texts) batches. Returns (params,
    opt_state, history). ``to_tree(params)`` gives what is saved (default:
    the module itself) and ``from_tree(params, tree)`` loads a checkpoint's
    tree into the params (default: the strict ``load_numpy_tree``); only
    the ``writer`` (rank 0 of a mesh) writes files, every rank reads."""
    to_tree = to_tree or (lambda p: p)
    from_tree = from_tree or load_numpy_tree
    start_step = 0
    if ckpt_dir and resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest:
            from_tree(params, load_pytree(latest))
            start_step = int(os.path.basename(latest)[5:-4])
            print(f"[train] resumed from {latest} (step {start_step})", flush=True)

    def save(n):
        tree = to_tree(params)  # a collective under tensor parallelism: every rank
        if writer:
            os.makedirs(ckpt_dir, exist_ok=True)
            save_pytree(tree, os.path.join(ckpt_dir, f"step_{n}.npz"))

    history = []
    t0 = time.perf_counter()
    for step in range(start_step, num_steps):
        images, texts = next(data_iter)
        params, opt_state, loss = step_fn(params, opt_state, images, texts)
        if (step + 1) % log_every == 0 or step + 1 == num_steps:
            loss_val = float(loss)
            rate = (step + 1 - start_step) / (time.perf_counter() - t0)
            history.append({"step": step + 1, "loss": loss_val})
            if writer:
                print(f"[train] step {step + 1}/{num_steps} loss {loss_val:.4f} "
                      f"({rate:.2f} it/s)", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save(step + 1)
    if ckpt_dir:
        save(num_steps)
    return params, opt_state, history
