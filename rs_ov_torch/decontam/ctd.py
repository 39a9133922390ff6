"""CTD, Cluster-Then-Debias, with DBSCAN on the device
(rs_ov/decontam/ctd.py:38-218).

DBSCAN over the patch tokens of each crop (N <= max_points), all crops at once:

  1. neighbour graph  A[i, j] = dist(x_i, x_j) <= eps (points L2-normalised)
  2. core points      deg(i) >= min_samples (self included, the sklearn rule)
  3. clusters         connected components of the core-core graph, each
                      labelled by its lowest core index (iterated min-label
                      propagation with pointer jumping until nothing changes)
  4. border points    the label of their lowest-index core neighbour
  5. labels renumbered in order of the components' lowest index; noise -1

The labels equal the JAX package's, whose while-loop of plain min-label
propagation reaches the same fixed point. Kept quirks of the reference: the
``_normalize_ref`` pseudo-normalisation x / (|x| + 1.1) before clustering
and in ``adaptive_debiasing`` (rs_ov/decontam/ctd.py:20-25).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DBSCANConfig", "dbscan", "cluster_patch_tokens_dbscan", "adaptive_debiasing"]


@dataclasses.dataclass(frozen=True)
class DBSCANConfig:
    eps: float = 1.1
    min_samples: int = 8
    metric: str = "cosine"  # 'cosine' | 'euclidean'
    use_spatial: bool = False
    spatial_weight: float = 0.25
    feat_weight: float = 1.0
    max_points: int = 4096
    refine_tokens: bool = False
    cls_subtract: bool = False
    cls_subtract_scale: float = 1.0
    cls_subtract_use_unit_cls: bool = True


def _normalize_ref(x: torch.Tensor, eps: float = 1.1) -> torch.Tensor:
    """The reference's eps=1.1 pseudo-normalisation (rs_ov/decontam/ctd.py:53-55)."""
    return x / (x.norm(dim=-1, keepdim=True) + eps)


def _dbscan_batched(points: torch.Tensor, eps: float, min_samples: int,
                    metric: str) -> torch.Tensor:
    """points [B, N, D] -> int32 labels [B, N] (-1 noise)."""
    b, n, _ = points.shape
    p = points.float()
    p = p / (p.norm(dim=-1, keepdim=True) + 1e-8)
    gram = torch.matmul(p, p.transpose(1, 2))
    if metric == "euclidean":
        sq = (p * p).sum(-1)
        adj = sq[:, :, None] + sq[:, None, :] - 2.0 * gram <= eps * eps
    elif metric == "cosine":
        adj = 1.0 - gram <= eps
    else:
        raise ValueError(f"Unsupported metric: {metric}")

    core = adj.sum(-1) >= min_samples
    idx = torch.arange(n, device=p.device).expand(b, n)
    big = n
    labels = torch.where(core, idx, big)
    core_adj = adj & core[:, :, None] & core[:, None, :]
    tail = torch.full((b, 1), big, device=p.device, dtype=labels.dtype)
    while True:
        prop = torch.where(core_adj, labels[:, None, :], big).amin(-1)
        new = torch.minimum(labels, prop)
        # pointer jumping: a core point's label is a core point of its component
        new = torch.minimum(new, torch.cat([new, tail], 1).gather(1, new))
        if torch.equal(new, labels):
            break
        labels = new

    first_core = torch.where(adj & core[:, None, :], idx[:, None, :], big).amin(-1)
    labels_ext = torch.cat([labels, tail], 1)
    border = labels_ext.gather(1, first_core)
    roots = torch.where(core, labels, torch.where(first_core < big, border, big))
    is_root = core & (labels == idx)
    rank = torch.cumsum(is_root.int(), dim=1) - 1
    rank_ext = torch.cat([rank, torch.full_like(rank[:, :1], -1)], 1)
    final = rank_ext.gather(1, roots.clamp(max=big))
    return torch.where(roots < big, final, -1).int()


def dbscan(points: torch.Tensor, *, eps: float, min_samples: int,
           metric: str = "euclidean") -> torch.Tensor:
    """points [N, D] -> int32 labels [N] (-1 noise), as
    rs_ov/decontam/ctd.py:58-114."""
    return _dbscan_batched(points[None], eps, min_samples, metric)[0]


def _segment_mean(values: torch.Tensor, labels: torch.Tensor, num_segments: int):
    """values [B, N, C], labels [B, N] -> per-cluster means [B, num_segments,
    C]; noise (-1) goes to a dropped segment."""
    b, _, c = values.shape
    seg = torch.where(labels >= 0, labels, num_segments).long()
    sums = values.new_zeros(b, num_segments + 1, c).scatter_add_(
        1, seg[..., None].expand(-1, -1, c), values)[:, :num_segments]
    counts = values.new_zeros(b, num_segments + 1).scatter_add_(
        1, seg, torch.ones_like(seg, dtype=values.dtype))[:, :num_segments]
    return sums / counts.clamp_min(1.0)[..., None]


def _per_point(per_cluster: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[B, n, ...] cluster values -> [B, N, ...] at each point's label (noise
    reads cluster 0; callers mask it)."""
    n = per_cluster.shape[1]
    idx = labels.clamp(0, n - 1).long()
    if per_cluster.dim() == 2:
        return per_cluster.gather(1, idx)
    return per_cluster.gather(1, idx[..., None].expand(-1, -1, per_cluster.shape[-1]))


def cluster_patch_tokens_dbscan(patch_tokens: torch.Tensor, grid_hw: tuple[int, int],
                                cfg: DBSCANConfig | dict | None = None,
                                cls_token: torch.Tensor | None = None):
    """patch_tokens [B, N, C] -> (refined tokens, labels [B, N] or None),
    rs_ov/decontam/ctd.py:126-188."""
    if isinstance(cfg, dict) or cfg is None:
        base = DBSCANConfig()
        if cfg:
            base = dataclasses.replace(base, **{k: v for k, v in cfg.items()
                                                if hasattr(base, k)})
        cfg = base
    if patch_tokens.dim() != 3:
        return patch_tokens, None
    b, n, _ = patch_tokens.shape
    hp, wp = int(grid_hw[0]), int(grid_hw[1])
    if hp * wp != n or n > int(cfg.max_points):
        return patch_tokens, None

    feats = patch_tokens.float()
    if cfg.metric == "cosine":
        pts = feats
    else:
        pts = cfg.feat_weight * _normalize_ref(feats)
        if cfg.use_spatial:
            yy, xx = torch.meshgrid(torch.linspace(0.0, 1.0, hp, device=feats.device),
                                    torch.linspace(0.0, 1.0, wp, device=feats.device),
                                    indexing="ij")
            xy = torch.stack([xx, yy], -1).reshape(n, 2)
            pts = torch.cat([pts, (cfg.spatial_weight * xy).expand(b, n, 2)], -1)
    labels = _dbscan_batched(pts, cfg.eps, cfg.min_samples, cfg.metric)
    member = (labels >= 0)[..., None]

    refined = patch_tokens
    if cfg.refine_tokens:
        means = _per_point(_segment_mean(feats, labels, n), labels)
        refined = torch.where(member, means.to(refined.dtype), refined)
    if cfg.cls_subtract and cls_token is not None:
        cls_f = cls_token.float()
        if cls_f.dim() == 1:
            cls_f = cls_f.expand(b, -1)
        cls_vec = _normalize_ref(cls_f) if cfg.cls_subtract_use_unit_cls else cls_f
        proto_u = _normalize_ref(_segment_mean(feats, labels, n))
        sims = (proto_u * _normalize_ref(cls_f)[:, None]).sum(-1).clamp(-1.0, 1.0)
        sub = _per_point(sims, labels)[..., None] * cls_vec[:, None] * cfg.cls_subtract_scale
        refined = torch.where(member, (refined.float() - sub).to(refined.dtype), refined)
    return refined, labels


def adaptive_debiasing(items: torch.Tensor, labels: torch.Tensor | None,
                       bias: torch.Tensor, *, factor: float,
                       eps: float = 1.1) -> torch.Tensor:
    """Clustered CLS addition (rs_ov/decontam/ctd.py:191-218):
    x_i <- x_i + cos_eps(M_k, cls) * factor * cls for i in cluster k, where
    M_k is the cluster mean; noise unchanged. items [B, N, Q], labels
    [B, N], bias [B, Q]."""
    if labels is None or items.dim() != 3 or labels.dim() != 2 or bias.dim() != 2:
        return items
    b, n, q = items.shape
    if tuple(labels.shape) != (b, n) or tuple(bias.shape) != (b, q) or factor == 0.0:
        return items
    items32 = items.float()
    protos = _segment_mean(items32, labels, n)
    proto_u = protos / (protos.norm(dim=-1, keepdim=True) + eps)
    cls_f = bias.float()
    cls_u = cls_f / (cls_f.norm(dim=-1, keepdim=True) + eps)
    sims = (proto_u * cls_u[:, None]).sum(-1).clamp(-1.0, 1.0)  # [B, n]
    add = _per_point(sims, labels)[..., None] * (factor * cls_f)[:, None]
    out = torch.where((labels >= 0)[..., None], items32 + add, items32)
    return out.to(items.dtype)
