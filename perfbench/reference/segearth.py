"""Plain reference of the SegEarth-OV production recipe, for the benchmark's
check of what the timed path produced.

It imports torch only (no kernel, no module of the measured program) and
follows the published recipe (SegEarth-OV, arXiv:2410.01768, with the
repository's ``configs/base_config.py`` options) from the public checkpoint
names: an OpenAI / open_clip CLIP vision tower (``visual.*``) and a SimFeatUp
``jbu_one`` upsampler (``upsampler.*``). Per 512-pixel-class image:

  uint8 RGB -> mean / std -> overlapping crops (``slide_crop`` every
  ``slide_stride``) -> ViT: front blocks (the state before block
  ``(layers - 1) // 2`` kept for the similarity map, the head-averaged
  attention of the last front block kept for outlier detection) -> last
  block, self-self attention without residual or MLP:
  softmax(softmax(k k^T s + q q^T s) + sim) v -> outlier suppression of the
  patch tokens -> ln_post -> @ proj -> global CLS debias -> jbu_one,
  ``num_stages`` 2x steps (radius 5 in the public checkpoint) -> final
  fixup -> L2 norm -> cosine logits -> bilinear resize to the crop ->
  overlap-average stitch -> softmax(logit_scale x) -> per class the max over
  its synonyms -> argmax.

Everything runs in fp32 with TF32 off (``run`` sets it), or, for the
benchmark's lower-precision control, with every product's operands rounded
to fp8 e4m3 under a per-tensor scale (``Arith(fp8=True)``), the step a later
change could take below the bf16 the configurations state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the recipe's preprocessing (SegEarth-OV configs: mmseg's data_preprocessor)
MEAN = (122.771, 116.746, 104.094)
STD = (68.501, 66.632, 70.323)

# neighbours of an outlier patch, in the order the writes land (last wins)
_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))

# the recipe options this reference implements, with the values it takes
SUPPORTED = {
    "model_type": ("Experimental",), "ignore_residual": (True,),
    "apply_sim_feat_up": (True,), "cls_token_lambda": (0.0,),
    "apply_outlier_suppression": (True,), "apply_similarity_enhancement": (True,),
    "prob_thd": (0.0,),
}


class Arith:
    """The reference's products: fp32, or each operand rounded to fp8 e4m3
    with a per-tensor scale (amax to 448) for the lower-precision control."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def op(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        scale = 448.0 / x.abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.op(a), self.op(b))


def _ln(x, sd, name, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def _heads(x, heads):
    b, l, d = x.shape
    return x.reshape(b, l, heads, d // heads).transpose(1, 2)


def _merge(x):
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def _qkv(x, sd, pre, heads, ar):
    y = ar.mm(x, sd[f"{pre}.attn.in_proj_weight"].t()) + sd[f"{pre}.attn.in_proj_bias"]
    return [_heads(t, heads) for t in y.chunk(3, dim=-1)]


def _out(ctx, sd, pre, ar):
    return ar.mm(_merge(ctx), sd[f"{pre}.attn.out_proj.weight"].t()) + \
        sd[f"{pre}.attn.out_proj.bias"]


def _block(x, sd, pre, heads, act, ar):
    """A residual block; also the head-averaged attention weights."""
    q, k, v = _qkv(_ln(x, sd, f"{pre}.ln_1"), sd, pre, heads, ar)
    attn = torch.softmax(ar.mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1)
    x = x + _out(ar.mm(attn, v), sd, pre, ar)
    h = act(ar.mm(_ln(x, sd, f"{pre}.ln_2"), sd[f"{pre}.mlp.c_fc.weight"].t())
            + sd[f"{pre}.mlp.c_fc.bias"])
    x = x + ar.mm(h, sd[f"{pre}.mlp.c_proj.weight"].t()) + sd[f"{pre}.mlp.c_proj.bias"]
    return x, attn.mean(1)


def _outlier_suppress(tok, attn, gh, gw, top_k, temp):
    """tok [B, P, C] patch tokens, attn [B, L, L] (CLS at 0): the top_k
    patches by attn[cls, i] / attn[i, i] are replaced by the
    (1 - cosine)-softmax-weighted mean of their 8 neighbours (clamped to the
    grid); each neighbour first loses strength * outlier, strength =
    clamp(cosine * temp, 0, 1), all from the unmodified tokens, written in
    outlier-major, neighbour-minor order, the last write winning, a
    neighbour clamped onto its outlier written not at all."""
    b, p, _ = tok.shape
    ratio = attn[:, 0, 1:] / (torch.diagonal(attn, dim1=-2, dim2=-1)[:, 1:] + 1e-8)
    idx = torch.topk(ratio, min(top_k, p), dim=-1).indices            # [B, K]
    rows, cols = idx // gw, idx % gw
    off = torch.tensor(_OFFSETS, device=tok.device)
    nr = (rows[..., None] + off[:, 0]).clamp(0, gh - 1)
    nc = (cols[..., None] + off[:, 1]).clamp(0, gw - 1)
    nidx = nr * gw + nc                                                # [B, K, 8]
    bi = torch.arange(b, device=tok.device)
    center = tok[bi[:, None], idx]                                     # [B, K, C]
    neigh = tok[bi[:, None, None], nidx]                               # [B, K, 8, C]
    cn = center / center.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    nn_ = neigh / neigh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = (nn_ * cn[:, :, None]).sum(-1)
    weights = torch.softmax((1.0 - sim).clamp_min(0.0), dim=-1)
    mean = (neigh * weights[..., None]).sum(2)
    clean = neigh - center[:, :, None] * (sim * temp).clamp(0.0, 1.0)[..., None]
    out = tok.clone()
    for k in range(idx.shape[1]):
        for j in range(len(_OFFSETS)):
            write = (nr[:, k, j] != rows[:, k]) | (nc[:, k, j] != cols[:, k])
            t = nidx[:, k, j]
            out[bi, t] = torch.where(write[:, None], clean[:, k, j], out[bi, t])
    out[bi[:, None], idx] = mean
    return out


def vit_tokens(sd, crops, tower, recipe, ar):
    """crops [B, 3, S, S] normalised fp32 -> (patch tokens [B, P, E], CLS
    embedding [B, E])."""
    p, heads = tower["patch_size"], tower["width"] // tower["head_width"]
    act = (lambda x: x * torch.sigmoid(1.702 * x)) if tower["quick_gelu"] else F.gelu
    b = crops.shape[0]
    gh, gw = crops.shape[-2] // p, crops.shape[-1] // p
    x = F.conv2d(ar.op(crops), ar.op(sd["visual.conv1.weight"]), stride=p)
    x = x.flatten(2).transpose(1, 2)
    cls = sd["visual.class_embedding"].expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + sd["visual.positional_embedding"]
    x = _ln(x, sd, "visual.ln_pre")
    n_front = tower["layers"] - 1
    mid = attn = None
    for i in range(n_front):
        if i == n_front // 2:
            mid = x
        x, attn = _block(x, sd, f"visual.transformer.resblocks.{i}", heads, act, ar)
    sim_cfg = recipe["similarity_enhancement_cfg"]
    f = mid[:, 1:]
    f = f / f.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = ar.mm(f, f.transpose(-1, -2)) / sim_cfg["temperature"]
    if not sim_cfg["add_self_similarity"]:
        sim = sim * (1.0 - torch.eye(sim.shape[-1], device=sim.device))
    sim = F.pad(sim, (1, 0, 1, 0))[:, None] * sim_cfg["similarity_weight"]
    pre = f"visual.transformer.resblocks.{n_front}"
    q, k, v = _qkv(_ln(x, sd, f"{pre}.ln_1"), sd, pre, heads, ar)
    s = q.shape[-1] ** -0.5
    w = torch.softmax(ar.mm(k, k.transpose(-1, -2)) * s + ar.mm(q, q.transpose(-1, -2)) * s,
                      dim=-1)
    out = _out(ar.mm(torch.softmax(w + sim, dim=-1), v), sd, pre, ar)
    oc = recipe["outlier_suppression_cfg"]
    patches = _outlier_suppress(out[:, 1:], attn, gh, gw, oc["top_k"], oc["contamination_temp"])
    y = _ln(torch.cat([out[:, :1], patches], dim=1), sd, "visual.ln_post")
    proj = sd["visual.proj"]
    return ar.mm(y[:, 1:], proj), ar.mm(y[:, 0], proj)


def _conv1x1(x, w, b, ar):
    y = torch.einsum("oc,bchw->bohw", ar.op(w.reshape(w.shape[0], -1)), ar.op(x))
    return y + b[None, :, None, None]


def _proj2(x, sd, pre, ar):
    return _conv1x1(F.gelu(_conv1x1(x, sd[f"{pre}.0.weight"], sd[f"{pre}.0.bias"], ar)),
                    sd[f"{pre}.3.weight"], sd[f"{pre}.3.bias"], ar)


def jbu_stage(src, guidance, sd, ar):
    """One learned-range joint bilateral 2x step: src [B, C, h, w], guidance
    [B, G, H, W] -> [B, C, H, W]; the window's diameter d from the fixup
    projection's d*d outputs."""
    d = round(sd["upsampler.up.fixup_proj.3.weight"].shape[0] ** 0.5)
    radius = d // 2
    pre = "upsampler.up"
    h, w = guidance.shape[-2:]
    proj = ar.op(_proj2(guidance, sd, f"{pre}.range_proj", ar))        # [B, K, H, W]
    win = F.unfold(F.pad(proj, [radius] * 4, mode="reflect"), d)
    win = win.reshape(proj.shape[0], proj.shape[1], d * d, h, w)
    logits = (win * proj[:, :, None]).sum(1)                            # [B, d*d, H, W]
    temp = torch.exp(sd[f"{pre}.range_temp"]).clamp(1e-4, 1e4)
    lin = torch.linspace(-1.0, 1.0, d, device=src.device)
    spatial = torch.exp(-(lin[:, None] ** 2 + lin[None, :] ** 2).reshape(-1)
                        / (2.0 * sd[f"{pre}.sigma_spatial"] ** 2))
    comb = torch.softmax(logits * temp, dim=1) * spatial[None, :, None, None]
    comb = comb / comb.sum(1, keepdim=True).clamp_min(1e-7)
    comb = comb + 0.1 * _proj2(torch.cat([comb, guidance], dim=1), sd, f"{pre}.fixup_proj", ar)
    hr = F.pad(F.interpolate(src, size=(h, w), mode="bicubic", align_corners=False),
               [radius] * 4, mode="reflect")
    comb, hr = ar.op(comb), ar.op(hr)
    out = src.new_zeros((src.shape[0], src.shape[1], h, w))
    for t in range(d * d):
        u, v = divmod(t, d)
        out += comb[:, t:t + 1] * hr[:, :, u:u + h, v:v + w]
    return out


def tile_grid(h, w, stride, crop):
    """(y1, x1, y2, x2) of the overlapping crops."""
    rows = max(h - crop + stride - 1, 0) // stride + 1
    cols = max(w - crop + stride - 1, 0) // stride + 1
    out = []
    for i in range(rows):
        for j in range(cols):
            y2, x2 = min(i * stride + crop, h), min(j * stride + crop, w)
            out.append((max(y2 - crop, 0), max(x2 - crop, 0), y2, x2))
    return out


def segment_image(sd, image, queries, query_idx, config, ar):
    """image [H, W, 3] uint8 on the device -> (class probabilities [C, H, W],
    labels [1, H, W] int64), fp32."""
    tower, recipe = config["tower"], config["recipe"]
    for key, allowed in SUPPORTED.items():
        if recipe[key] not in allowed:
            raise NotImplementedError(f"reference: {key}={recipe[key]!r} not implemented")
    if recipe["sim_feat_up_cfg"]["model_name"] != "jbu_one" or tower.get("no_ln_pre"):
        raise NotImplementedError("reference: jbu_one on a tower with ln_pre only")
    mean = torch.tensor(MEAN, device=image.device)
    std = torch.tensor(STD, device=image.device)
    x = ((image.float() - mean) / std).permute(2, 0, 1)
    h, w = x.shape[-2:]
    crop, p = recipe["slide_crop"], tower["patch_size"]
    if crop % p:
        raise NotImplementedError("reference: crops that are whole patches only")
    coords = tile_grid(h, w, recipe["slide_stride"], crop)
    crops = torch.stack([x[:, y1:y2, x1:x2] for y1, x1, y2, x2 in coords])
    tokens, cls = vit_tokens(sd, crops, tower, recipe, ar)
    cls = cls / cls.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    fac = recipe["global_debias_factor"]
    tn = tokens / tokens.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    tokens = tokens - cls[:, None] * ((tn * cls[:, None]).sum(-1, keepdim=True) * fac)
    g = crop // p
    feats = tokens.transpose(1, 2).reshape(len(coords), -1, g, g)
    for _ in range(recipe["sim_feat_up_cfg"]["num_stages"]):
        hh, ww = feats.shape[-2] * 2, feats.shape[-1] * 2
        feats = jbu_stage(feats, F.adaptive_avg_pool2d(crops, (hh, ww)), sd, ar)
    feats = feats + 0.1 * _conv1x1(feats, sd["upsampler.fixup_proj.1.weight"],
                                   sd["upsampler.fixup_proj.1.bias"], ar)
    feats = feats / feats.norm(dim=1, keepdim=True).clamp_min(1e-12)
    logits = torch.einsum("bchw,qc->bqhw", ar.op(feats), ar.op(queries))
    logits = F.interpolate(logits, size=(crop, crop), mode="bilinear", align_corners=False)
    canvas = torch.zeros((logits.shape[1], h, w), device=image.device)
    count = torch.zeros((1, h, w), device=image.device)
    for t, (y1, x1, y2, x2) in enumerate(coords):
        canvas[:, y1:y2, x1:x2] += logits[t]
        count[:, y1:y2, x1:x2] += 1.0
    probs = torch.softmax(canvas / count * recipe["logit_scale"], dim=0)
    n_cls = max(query_idx) + 1
    qi = torch.tensor(query_idx, device=image.device)
    probs = torch.stack([probs[qi == c].amax(0) for c in range(n_cls)])
    return probs, probs.argmax(0, keepdim=True)


def run(sd, images, queries, query_idx, config, fp8: bool = False):
    """Each uint8 image [H, W, 3] of ``images`` (on the device) through the
    reference -> lists of probabilities and labels. TF32 is turned off for
    the call and restored."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ar = Arith(fp8)
        with torch.no_grad():
            out = [segment_image(sd, im, queries, query_idx, config, ar) for im in images]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return [o[0] for o in out], [o[1] for o in out]
