"""Worker functions for the port's multi-process CPU tests: each runs in a
process of ``torch.multiprocessing.spawn``, joins a gloo group through a
``file://`` store (no port, so parallel test workers never collide), and
rank 0 writes its results to an ``.npz`` for the parent. They import only
torch and the port."""

import numpy as np
import torch
import torch.distributed as dist

from rs_ov_torch.parallel.mesh import initialize_distributed, make_mesh


def _join(rank, world, store):
    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", world_size=world, rank=rank, device="cpu")


def _flat_grads(module):
    return {n: p.grad.detach().numpy().copy() for n, p in module.named_parameters()}


def losses_worker(rank, world, store, out, img, txt, scale, bias):
    """clip_loss (gathered), its local_loss variant and siglip_loss (ring)
    on this rank's rows; rank 0 writes the losses and the gathered
    gradients of the features."""
    from rs_ov_torch.parallel.collectives import all_gather_with_grad
    from rs_ov_torch.train import losses

    _join(rank, world, store)
    group = dist.group.WORLD
    b = img.shape[0] // world
    res = {}
    for name in ("clip", "clip_local", "siglip"):
        i = torch.from_numpy(img[rank * b:(rank + 1) * b].copy()).requires_grad_()
        t = torch.from_numpy(txt[rank * b:(rank + 1) * b].copy()).requires_grad_()
        if name == "siglip":
            loss = losses.siglip_loss(i, t, torch.tensor(scale), torch.tensor(bias), group=group)
        else:
            loss = losses.clip_loss(i, t, torch.tensor(scale), group=group,
                                    local_loss=name == "clip_local")
        loss.backward()
        summed = loss.detach().clone()
        dist.all_reduce(summed)
        with torch.no_grad():
            res[f"{name}_loss"] = (summed / world).numpy()
            res[f"{name}_gi"] = all_gather_with_grad(i.grad, group).numpy()
            res[f"{name}_gt"] = all_gather_with_grad(t.grad, group).numpy()
    if rank == 0:
        np.savez(out, **res)
    dist.destroy_process_group()


def clip_step_worker(rank, world, store, out, tree, cfg, images, texts, mesh_shape, loss,
                     accum):
    """One make_clip_train_step backward on a (data, model) mesh; rank 0
    writes the loss and the whole gradient (shards gathered)."""
    from rs_ov_torch.core.params import clip_params_from_numpy
    from rs_ov_torch.parallel import sharding
    from rs_ov_torch.train import step

    _join(rank, world, store)
    dp, tp = mesh_shape
    mesh = make_mesh(dp, tp, device_type="cpu")
    params = clip_params_from_numpy(tree, cfg).requires_grad_()
    if tp > 1:
        params = sharding.shard_params(params, mesh)
    d = mesh.get_local_rank("data")
    b = images.shape[0] // dp
    fn, _ = step.make_clip_train_step(cfg, mesh, loss=loss, accum_steps=accum)
    value = fn.backward(params, images[d * b:(d + 1) * b], texts[d * b:(d + 1) * b])
    with torch.no_grad():
        for p in params.parameters():
            p.data = p.grad
        grads = _flat_grads(params) if tp == 1 else {
            n: p.detach().numpy() for n, p in sharding.gather_params(params, mesh).named_parameters()}
    if rank == 0:
        np.savez(out, loss=value.numpy(), **{f"g/{k}": v for k, v in grads.items()})
    dist.destroy_process_group()


def blip_step_worker(rank, world, store, out, tree, cfg, batch, enc_id):
    """One data-parallel BLIP retrieval backward with the argmax sampler;
    rank 0 writes the losses, the gradient and the queue."""
    from rs_ov_torch.core.params import blip_retrieval_state_from_numpy
    from rs_ov_torch.train import blip_retrieval

    _join(rank, world, store)
    blip_retrieval._sample_negatives = lambda logits, gen: logits.argmax(1)
    mesh = make_mesh(world, 1, device_type="cpu")
    state = blip_retrieval_state_from_numpy(tree)
    b = batch[0].shape[0] // world
    mine = [x[rank * b:(rank + 1) * b] for x in batch]
    fn, _ = blip_retrieval.make_blip_retrieval_train_step(cfg, mesh, enc_token_id=enc_id)
    losses = fn.backward(state, *mine, 0.4, torch.Generator())
    if rank == 0:
        np.savez(out, losses=np.asarray([float(x) for x in losses]),
                 queue_image=state["queue"]["image"].numpy(),
                 ptr=state["queue"]["ptr"].numpy(),
                 **{f"g/{k}": v for k, v in _flat_grads(state["params"]).items()})
    dist.destroy_process_group()


def cli_worker(rank, world, store, out, module, argv):
    """A training CLI's ``main(argv)`` on this rank, in a group joined through
    the store, with WORLD_SIZE set as torchrun sets it (the CLI then finds
    the group joined); rank 0 writes the last JSON line the CLI printed."""
    import contextlib
    import importlib
    import io
    import os

    _join(rank, world, store)
    os.environ["WORLD_SIZE"] = str(world)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(module).main(argv)
    if rank == 0:
        np.savez(out, last=[ln for ln in buf.getvalue().splitlines() if ln.startswith("{")][-1])


def spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, world, store, out, *args)`` on ``world`` gloo ranks;
    returns rank 0's results."""
    out = str(tmp_path / "out.npz")
    torch.multiprocessing.spawn(fn, args=(world, str(tmp_path / "store"), out, *args),
                                nprocs=world, join=True)
    with np.load(out) as f:
        return dict(f)


def segmentor_mesh_worker(rank, world, store, out, kwargs, cases, images, states):
    """SegmentorEx(mesh=...) on this rank for each case (name -> (mesh shape,
    extra kwargs, "raw" for predict_raw of the first image or "batch" for
    predict_batch_raw of all)); then each rank's confusion state summed over
    the "data" group, as an fp32 tensor and as a float64 numpy array. Every
    rank writes its results: rank 0 to ``out``, rank r to ``out.r<r>.npz``."""
    from rs_ov_torch.parallel.collectives import sum_over
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    _join(rank, world, store)
    res = {}
    for name, (shape, extra, entry) in cases.items():
        seg = SegmentorEx(**kwargs, **extra, mesh=make_mesh(*shape, device_type="cpu"),
                          device="cpu")
        got = (seg.predict_raw(images[:1]) if entry == "raw"
               else seg.predict_batch_raw(images))
        for i, r in enumerate(got):
            res[f"{name}/{i}/probs"] = r["seg_logits"].numpy()
            res[f"{name}/{i}/pred"] = r["pred_sem_seg"].numpy()
    group = make_mesh(world, 1, device_type="cpu").get_group("data")
    res["state_fp32"] = sum_over(torch.from_numpy(states[rank]).float(), group).numpy()
    res["state_fp64"] = sum_over(states[rank], group)
    res["own_state_after"] = states[rank]
    np.savez(out if rank == 0 else f"{out}.r{rank}.npz", **res)
    dist.destroy_process_group()
