"""The widest gaps of ``motionbert.video``'s check over many seeds, located:
for each seed, the cell's set-up and a short window as ``perfbench/control.py``
makes them, then the checked videos against the plain f32 reference
(``harness/compare.output_gaps``), and where the widest gap lies (the
video's length, the frame, whether one clip or two cover it, the joint and
the coordinate) with the reference's, the program's and the plain bf16
route's (``use_kernels=False``) values there.

Run on the card from the repository root:
``python3 experiments/dstformer_gaps.py --seeds 3000000001,3000000002``
(one JSON line a seed, then a summary line).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="motionbert.video")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose benchmark is read")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import compare
    from perfbench.harness.registry import Registry
    from pose3d_tpu_torch.models.temporal import clip_starts
    from pose3d_tpu_torch.pipeline.lift import lift_sequence

    reg = Registry(Path(args.root))
    cell = reg.workload(args.workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    driver = reg.driver(traffic["driver"])
    widest = []
    for seed in (int(s) for s in args.seeds.split(",")):
        c = driver.Cell(cfg, traffic, seed, torch.device(args.device))
        c.window(args.seconds)
        refs, progs = c.reference(), c.program()
        gaps = compare.output_gaps(progs, refs)
        best = None
        for (off, size, out), ref in zip(c._checked(), refs):
            d = np.abs(out - ref.cpu().numpy())
            i = np.unravel_index(int(d.argmax()), d.shape)
            if best is None or d[i] > best[0]:
                best = (float(d[i]), off, size, i, ref.cpu().numpy()[i], out[i])
        gap, off, size, (f, j, k), want, got = best
        plain = lift_sequence(c.model, c.pool[off:off + size], 1000.0, use_kernels=False)
        length = min(cfg["clip_len"], size)
        covering = sum(s <= f < s + length for s in clip_starts(size, length, max(length // 2, 1)))
        row = {"seed": seed, **gaps, "frames": int(size), "frame": int(f), "joint": int(j),
               "coord": "xyz"[k], "clips_covering": int(covering), "reference": float(want),
               "program": float(got), "plain_bf16": float(plain[f, j, k]),
               "plain_gap": float(abs(plain[f, j, k] - want))}
        print(json.dumps(row), flush=True)
        widest.append(gap)
        c.release()
        del c
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"seeds": len(widest), "max": max(widest),
                      "median": statistics.median(widest),
                      "sorted_top5": sorted(widest)[-5:]}), flush=True)


if __name__ == "__main__":
    main()
