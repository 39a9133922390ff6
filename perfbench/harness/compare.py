"""The comparison that decides ``correct``: what the timed path returned
against the plain reference, image by image.

Numbers, each the worst over the images compared:

  prob_gap_mean       mean |p - p_ref| of the class probabilities
                      (``seg_logits``)
  label_regret_mean   mean over pixels of how far the reference's
                      probability of the label the program chose
                      (``pred_sem_seg``) lies below the reference's best:
                      0 where the label is the reference's, small where a
                      flip lands on a near tie, large where it does not
  label_flip_share    share of pixels whose label differs from the
                      reference's (read, not judged: near ties make it swing
                      with the seed, 7e-4 to 2.5e-2 in sound runs)
  label_flip_decided  the same over the decided pixels only, where the
                      reference's two most likely classes lie
                      ``decided_margin`` or more apart (read, not judged:
                      the fp8 control flips no decided pixel on some seeds,
                      so it has no upper reading)
  decided_share       share of decided pixels (read, not judged)

A configuration's ``limits`` name the numbers judged, each with its bound,
{"max": x} or {"min": x}.
"""

from __future__ import annotations


def numbers(program: list, reference: list, margin: float) -> dict:
    """program, reference: [(probs [C, H, W], labels [1, H, W])] of the same
    images, on one device."""
    gaps, regret, flips, flips_sure, decided = [], [], [], [], []
    for (p, lp), (r, lr) in zip(program, reference):
        gaps.append((p.float() - r).abs().mean().item())
        top2 = r.topk(2, dim=0).values
        sure = (top2[0] - top2[1]) >= margin
        chosen = lp.reshape(1, *sure.shape).long()
        if int(chosen.min()) < 0 or int(chosen.max()) >= r.shape[0]:
            regret.append(1.0)  # a label that names no class
        else:
            regret.append((top2[0] - r.gather(0, chosen)[0]).mean().item())
        wrong = chosen[0] != lr.reshape(sure.shape).long()
        flips.append(wrong.float().mean().item())
        decided.append(sure.float().mean().item())
        flips_sure.append((wrong & sure).sum().item() / max(int(sure.sum().item()), 1))
    return {"prob_gap_mean": max(gaps), "label_regret_mean": max(regret),
            "label_flip_share": max(flips),
            "label_flip_decided": max(flips_sure), "decided_share": min(decided)}


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every judged number inside its limit, {name: {"value", "max" or
    "min"}} of the judged numbers)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = nums[name]
        if "max" in limit:
            ok &= value <= limit["max"]
        else:
            ok &= value >= limit["min"]
        checks[name] = {"value": value, **limit}
    return bool(ok), checks
