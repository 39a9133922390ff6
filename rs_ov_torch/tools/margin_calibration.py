"""Phase 5's decided-pixel agreement at every candidate margin, on the card.

    python3 -m rs_ov_torch.tools.margin_calibration [--out work_dirs/margin_calibration.json]

Run from the repository's root: it drives ``chip_smoke.py``'s phase 5 (one
336x336 image through every route on the card and the fp32 CPU references,
the base config's segmentors at full ViT-B/16 width, random weights) and
prints, for every pair of ``chip_smoke.E2E_PAIRS``, the all-pixel argmax
agreement and, at each margin of ``chip_smoke.TAUS``, the agreement on the
pixels the reference run decides (top-1 minus top-2 class probability at
least the margin) and their share of the image; then the same for three
planted faults of the bf16 default route against the fp32 CPU run: one of
the last block's 12 attention heads zeroed, the global CLS debias left out
(``global_debias_factor=0``) and the mid-layer similarity map left out
(``apply_similarity_enhancement=False``). ``chip_smoke.TAU`` is chosen from
this table; nothing is asserted here.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("work_dirs", "margin_calibration.json"))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("margin_calibration: no CUDA device")
    import chip_smoke as cs
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    cs.phase_device()
    cs.phase_build()
    segs = cs._segmentors()
    out, _labels, _cpu_s = cs._e2e_outputs(segs)
    img, qf = cs._e2e_image(), segs["base"].query_features.cpu().numpy()
    runs = [(f"{a} vs {b}", out[a], out[b], need) for a, b, need in cs.E2E_PAIRS]
    with cs._one_head_zeroed():
        bad = segs["base"].predict_raw(img)[0]
    runs.append(("fault: one head zeroed vs fp32 CPU", bad, out["fp32 CPU"], None))
    for name, change in (("global debias left out", {"global_debias_factor": 0.0}),
                         ("similarity map left out", {"apply_similarity_enhancement": False})):
        seg = SegmentorEx(**{**cs._base_model_cfg(), **change}, device=cs.DEV, query_features=qf)
        runs.append((f"fault: {name} vs fp32 CPU", seg.predict_raw(img)[0], out["fp32 CPU"], None))
    table = {}
    for name, run, ref, need in runs:
        row = {str(t): cs._pair_numbers(run, ref, t) for t in cs.TAUS}
        table[name] = {"need": need, **row}
        print(f"[margin] {name} (need {need}): all {row[str(cs.TAUS[0])][0]:.6f}; "
              + "; ".join(f"{t}: {row[str(t)][1]:.6f} on {row[str(t)][2]:.4f}"
                          for t in cs.TAUS))
    result = {"card": cs.CARD["smi"], "table": table}
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
