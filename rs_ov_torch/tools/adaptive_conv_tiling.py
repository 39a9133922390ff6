"""The tiling sweep of the banded adaptive conv kernel: K4a (bf16), K4b
(fp32), K4c (planes), K4d (channels-last), K4e and K4f (both operands
rounded to bf16) in each operand pair.

    python3 -m rs_ov_torch.tools.adaptive_conv_tiling [--out work_dirs/adaptive_conv_tiling.json]
        [--kernels K4a K4b K4c K4d K4e K4f]

For K4a and K4b at each of the channel-first route's shapes (B=2, C=512:
d=11 at 56^2 and 28^2, d=7 at 56^2), for K4c and K4d in each pair of input
and tap dtypes (bf16 or fp32 each) at d=11, 56^2 and 28^2, and for K4e and
K4f in each pair at those and at jbu_stack's d=7, 224^2, times the bare
library call at every tiling the kernel takes, R in (1, 2, 4, 8) output
rows a block by 16, 32, 64 or 128 channels a warp (the blocks whose shared
memory fits), as device time per launch (CUDA events around 20 launches
back to back, the median of 9 such runs, after 3 launches; K4d's
channels-last copy of the input made once, outside), checks each tiling's
output against the plain version (max|d|/max|ref|: 1e-5 with an fp32
input, 1e-2 with a bf16 one), and prints the times, the fastest tiling per
shape and the wrapper's choice (``kernels.adaptive_conv._tiling``) beside
the card's name and power limit. Not in the default run: ``--kernels K4e
K4f`` (no request calls them).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

SHAPES = ((11, 56), (11, 28), (7, 56))
PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
         (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))
B, C = 2, 512
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def _median_ms(fn, reps: int = 9, launches: int = 20) -> float:
    """Device ms of one launch: the median over ``reps`` of CUDA events around
    ``launches`` launches back to back (the host's launch time hidden)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("work_dirs", "adaptive_conv_tiling.json"))
    ap.add_argument("--kernels", nargs="*", default=["K4a", "K4b", "K4c", "K4d"])
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("adaptive_conv_tiling: no CUDA device")
    from rs_ov_torch.kernels import adaptive_conv as ac
    from rs_ov_torch.kernels.build import check, load_library

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(k, (dt, dt), d, hw) for k, dt in (("K4a", bf), ("K4b", f32)) for d, hw in SHAPES]
    cases += [(k, pair, 11, hw) for k in ("K4c", "K4d") for pair in PAIRS for hw in (56, 28)]
    cases += [(k, pair, d, hw) for k in ("K4e", "K4f") for pair in PAIRS
              for d, hw in ((11, 56), (11, 28), (7, 224))]
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card, "runs": []}
    for key, (dt_in, dt_f), d, hw in (c for c in cases if c[0] in opts.kernels):
        channels_last, rounded = key == "K4d", key in ("K4e", "K4f")
        plain = ac.adaptive_conv_bf16_plain if rounded else ac.adaptive_conv_tapmajor_plain
        inp = torch.from_numpy(rng.randn(B, C, hw + d - 1, hw + d - 1).astype(np.float32))
        filt = torch.from_numpy(rng.randn(B, d * d, hw, hw).astype(np.float32))
        inp, filt = inp.to(dev, dt_in), filt.to(dev, dt_f)
        ref = plain(inp, filt, d).float()
        scale = ref.abs().max().item()
        times = {}
        for rows in ac.ROWS:
            for cw in ac.WARP_CHANNELS:
                if ac._smem_bytes(d, rows, cw, dt_in, dt_f, channels_last,
                                  rounded) > ac.SMEM_MAX:
                    continue
                if key in ("K4a", "K4b"):
                    out, name, args, _keep = ac._adaptive_conv_operands(inp, filt, d, (rows, cw))
                elif rounded:
                    out, name, args, _keep = ac._rounded_operands(inp, filt, d, key == "K4f",
                                                                  (rows, cw))
                else:
                    out, name, args, _keep = ac._layout_operands(inp, filt, d, channels_last,
                                                                 (rows, cw))
                entry = getattr(load_library(), name)
                check(entry(*args, stream), name)
                rel = (out.float() - ref).abs().max().item() / scale
                assert rel <= TOL[dt_in], (key, dt_in, dt_f, d, hw, rows, cw, rel)
                ms = _median_ms(lambda: entry(*args, stream))  # noqa: B023
                times[f"{rows}x{cw}"] = ms
                result["runs"].append(dict(kernel=key, dtype=str(dt_in)[6:],
                                           taps=str(dt_f)[6:], d=d, hw=hw, rows=rows, cw=cw,
                                           cb=cw * 8 // rows, ms=ms, rel_err=rel))
        best = min(times, key=times.get)
        chosen = "{}x{}".format(*ac._tiling(B, C, hw, hw, d, dt_in, ac._sm_count(0), dt_f,
                                            channels_last, rounded))
        print(f"[tiling] {key} inp {str(dt_in)[6:]} taps {str(dt_f)[6:]} d={d} H=W={hw}: "
              f"fastest R x channels/warp {best} {times[best]:.4f} ms; the wrapper's {chosen} "
              f"{times[chosen]:.4f} ms; " + " ".join(f"{k} {v:.4f}" for k, v in times.items()))
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
