"""Evaluate every dataset config in one process (the JAX package's
eval_all.py, plus --device):

    python -m rs_ov_torch.eval_all --work-dir work_dirs/all --json-out summary.json

One segmentor per config; a config that fails (a missing dataset, an
undecodable file) gives an error entry in the summary, not a crash.
"""

from __future__ import annotations

import argparse
import json
import traceback

from rs_ov_torch.eval import RESULT_KEYS, build_model_overrides

CONFIGS = [
    # rs semantic segmentation
    "./configs/cfg_openearthmap.py",
    "./configs/cfg_loveda.py",
    "./configs/cfg_isaid.py",
    "./configs/cfg_potsdam.py",
    "./configs/cfg_vaihingen.py",
    "./configs/cfg_uavid.py",
    "./configs/cfg_udd5.py",
    "./configs/cfg_vdd.py",
    # rs single-class
    "./configs/cfg_whu_building.py",
    "./configs/cfg_whu_sat_II.py",
    "./configs/cfg_inria.py",
    "./configs/cfg_xbd.py",
    "./configs/cfg_chn6-cug.py",
    "./configs/cfg_deepglobe_road.py",
    "./configs/cfg_massachusetts_road.py",
    "./configs/cfg_spacenet_road.py",
    "./configs/cfg_wbs-si.py",
]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--work-dir", default="work_dirs/all")
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--upsampler-checkpoint", default=None,
                        help="SimFeatUp checkpoint path (see rs_ov_torch.eval)")
    parser.add_argument("--jbu-stages", type=int, default=None,
                        help="JBU stages (see rs_ov_torch.eval; a checkpoint without "
                             "this flag pins 4)")
    parser.add_argument("--batch-images", type=int, default=1,
                        help="predict N same-shape images as one batch of crops")
    parser.add_argument("--json-out", default=None,
                        help="also write the summary dict to this file")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the segmentors (default cuda)")
    args = parser.parse_args(argv)

    from rs_ov_torch.evalsuite.runner import run_eval

    overrides = build_model_overrides(args.checkpoint, args.upsampler_checkpoint,
                                      args.jbu_stages)
    overrides["device"] = args.device
    summary = {}
    for config in CONFIGS:
        print(f"Running {config}", flush=True)
        try:
            r = run_eval(config, work_dir=args.work_dir, max_samples=args.max_samples,
                         model_overrides=overrides, batch_images=args.batch_images)
            summary[config] = {k: r[k] for k in RESULT_KEYS if k in r}
        except FileNotFoundError as e:
            summary[config] = {"error": f"dataset missing: {e}"}
        except Exception:
            summary[config] = {"error": traceback.format_exc(limit=3)}
    out = json.dumps(summary, indent=2)
    print(out)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(out + "\n")
    return summary


if __name__ == "__main__":
    main()
