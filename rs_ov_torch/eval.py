"""Single-dataset evaluation CLI of the port (the flags of the JAX package's
eval.py, plus --device).

    python -m rs_ov_torch.eval --config configs/cfg_potsdam.py --work-dir work_dirs/potsdam

It runs on the CUDA card unless ``--device cpu`` is given. --checkpoint /
--upsampler-checkpoint load reference-named weights (nothing is downloaded);
--shard R/W evaluates every W-th image from R, and --merge DIST_DIR folds
the shards' saved states into one result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

RESULT_KEYS = ("aAcc", "mIoU", "mAcc", "num_images", "tiles512_per_sec",
               "tiles512_per_sec_steady", "img_per_sec_sustained",
               "tiles512_per_sec_sustained")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="rs_ov_torch open-vocab segmentation eval")
    parser.add_argument("--config", default="./configs/cfg_potsdam.py")
    parser.add_argument("--work-dir", default="./work_logs/")
    parser.add_argument("--show", action="store_true", help="(accepted, unused)")
    parser.add_argument("--show-dir", default="./show-dir/")
    parser.add_argument("--save-seg-dir", default=None,
                        help="directory for per-image colorized masks")
    parser.add_argument("--save-heatmap-dir", default=None,
                        help="directory for per-image confidence heatmaps")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm", "mpi", "jax"],
                        default="none", help="accepted for compat; sharding via --shard")
    parser.add_argument("--local_rank", "--local-rank", type=int, default=0)
    parser.add_argument("--checkpoint", default=None, help="CLIP torch checkpoint path")
    parser.add_argument("--upsampler-checkpoint", default=None,
                        help="SimFeatUp checkpoint path")
    parser.add_argument("--jbu-stages", type=int, default=None,
                        help="JBU stages (default 2; 4 = reference semantics, pinned "
                             "when a checkpoint is given without this flag)")
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--batch-images", type=int, default=1,
                        help="predict N same-shape images as one batch of crops")
    parser.add_argument("--shard", default="0/1", help="rank/world for dataset sharding")
    parser.add_argument("--merge", default=None, metavar="DIST_DIR",
                        help="merge per-rank metric states under DIST_DIR "
                             "(rank*/metric_state.npz) into one result and exit")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the segmentor (default cuda; cpu runs "
                             "without a card)")
    return parser.parse_args(argv)


def build_model_overrides(checkpoint, upsampler_checkpoint, jbu_stages):
    """The CLI's checkpoint and stage flags as segmentor overrides. Real
    weights without an explicit stage count pin num_stages to 4, the
    reference's fixed 4-stage 16x upsampler (reference
    simfeatup_dev/upsamplers.py:304-325), so that a parity run never
    compares the 2-stage default against it; RS_OV_JBU_STAGES still wins
    inside SegmentorEx, with a warning here."""
    overrides = {}
    if checkpoint:
        overrides["checkpoint_path"] = checkpoint
    if upsampler_checkpoint:
        overrides["sim_feat_up_cfg"] = {"model_name": "jbu_one",
                                        "model_path": upsampler_checkpoint}
    if jbu_stages is not None or checkpoint or upsampler_checkpoint:
        cfg = dict(overrides.get("sim_feat_up_cfg") or {"model_name": "jbu_one"})
        cfg["num_stages"] = 4 if jbu_stages is None else jbu_stages
        overrides["sim_feat_up_cfg"] = cfg
        env = os.environ.get("RS_OV_JBU_STAGES")
        if jbu_stages is None and env is not None and env != "4":
            print(f"WARNING: RS_OV_JBU_STAGES={env} overrides the checkpoint parity pin "
                  "(num_stages=4); this run is NOT a reference-semantics parity run",
                  file=sys.stderr, flush=True)
    return overrides


def main(argv=None):
    args = parse_args(argv)
    if args.merge:
        from rs_ov_torch.evalsuite.runner import merge_eval_results

        results = merge_eval_results(args.merge)
        print(json.dumps({k: results[k] for k in
                          ("aAcc", "mIoU", "mAcc", "num_images", "num_shards")}, indent=2))
        return
    from rs_ov_torch.evalsuite.runner import run_eval

    rank, world = (int(x) for x in args.shard.split("/"))
    overrides = build_model_overrides(args.checkpoint, args.upsampler_checkpoint,
                                      args.jbu_stages)
    overrides["device"] = args.device
    results = run_eval(args.config, work_dir=args.work_dir, shard=(rank, world),
                       max_samples=args.max_samples, model_overrides=overrides,
                       save_seg_dir=args.save_seg_dir or os.environ.get("SAVE_SEG_DIR"),
                       save_heatmap_dir=(args.save_heatmap_dir
                                         or os.environ.get("SAVE_HEATMAP_DIR")),
                       batch_images=args.batch_images)
    print(json.dumps({k: results[k] for k in RESULT_KEYS if k in results}, indent=2))


if __name__ == "__main__":
    main()
