"""A/B of DSTformer's sub-block routes, on one card: the fused launches
against the same sub-block with only its attention on them.

Routes:

- ``fused``: this checkout as it is, ``ops.dstformer.sub_block`` (five
  launches of ``csrc/dstformer.cu``: LayerNorm, bias, GELU and residual
  inside the products);
- ``attention_only``: this checkout with ``ops.dstformer.sub_block``
  replaced by ``attention_only`` below: the products in cuBLAS
  (``nn.functional.linear``), LayerNorm, GELU and the residual adds as
  PyTorch passes, and the attention on ``ops.dstformer.attend``, in place
  on the frame-major rows (so, as in ``fused``, no transpose copy);
- ``parent``: the tree given by ``--parent`` (e.g. a ``git archive`` of
  the parent commit), run as it is.

``--kernels N``: at 16 clips x 243 frames, N rounds of the spatial and
temporal sub-block on ``fused``, ``attention_only`` and the module route
(``DSTBlock._sub_block``, the temporal one between its transposes), in
turn, CUDA events (chip_smoke's ``cuda_ms``); prints ms a call.

``--seeds a,b,...``: a fresh process of ``perfbench/run.py --workload
<cell>`` per route and seed, the routes' order rotated from seed to seed;
appends each result line to ``<--out>/<cell>_<trace>.jsonl`` (default
``logs/route_ab``)
and prints, per route, the median and spread (IQR / median) of each
end-to-end metric, and per seed the ratio of each route to ``fused``.

Run from the repository root on the card:
``python3 experiments/dstformer_route_ab.py --kernels 3``
``python3 experiments/dstformer_route_ab.py --seeds 1,2 --routes parent,fused,attention_only
--parent logs/parent``
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
METRICS = ("infer_frames_per_s", "request_p95_ms", "train_frames_per_s", "setup_s")

CHILD = r'''
import runpy, sys
sys.path[:0] = [".", "experiments"]
import dstformer_route_ab
dstformer_route_ab.install()
sys.argv = ["perfbench/run.py", *sys.argv[1:]]
runpy.run_path("perfbench/run.py", run_name="__main__")
'''


def attention_only(x, w, axis: str, frames: int):
    """One sub-block as the module route runs it (its bf16 products and
    passes, each rounding) around the in-place attention launch."""
    from torch.nn import functional as F

    from pose3d_tpu_torch.ops import dstformer as D

    o = D.attend(D.ln_qkv_reference(x, w), axis, frames)
    x1 = x + F.linear(o, w.proj_w, w.proj_b)
    y = F.layer_norm(x1, (x1.shape[-1],), w.ln2_w, w.ln2_b, D.LN_EPS)
    return x1 + F.linear(F.gelu(F.linear(y, w.fc1_w, w.fc1_b)), w.fc2_w, w.fc2_b)


def install() -> None:
    """Sends ``ops.dstformer.sub_block``'s callers to ``attention_only``,
    its counters kept."""
    from pose3d_tpu_torch.ops import dstformer as D

    def sub_block(x, w, axis, frames):
        sub_block.fused += 1
        return attention_only(x, w, axis, frames)

    sub_block.fused, sub_block.launches = D.sub_block.fused, D.sub_block.launches
    D.sub_block = sub_block


def time_kernels(rounds: int) -> None:
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as C
    from pose3d_tpu_torch.ops import dstformer as D

    frames, clips = 243, C.DST_CLIPS
    with torch.inference_mode():
        model = C.seeded_dstformer("cuda", torch.bfloat16)
        x = C.dstformer_tokens(model, clips, frames, C.SEED + 40)
        x4 = x.view(clips, frames, 17, -1)
        block = model.blocks_st[0]
        routes = {
            "fused": lambda w, axis: D.sub_block(x, w, axis, frames),
            "attention_only": lambda w, axis: attention_only(x, w, axis, frames),
            "module": lambda w, axis: block._sub_block("s", x4.reshape(-1, 17, 512), True)
            if axis == "s" else block._sub_block(
                "t", x4.transpose(1, 2).reshape(-1, frames, 512), True).view(
                clips, 17, frames, 512).transpose(1, 2).contiguous()}
        times = {f"{r}_{a}": [] for r in routes for a in "st"}
        for _ in range(rounds):
            for axis in "st":
                w = D.weights(block, axis)
                for name, fn in routes.items():
                    times[f"{name}_{axis}"].append(C.cuda_ms(lambda: fn(w, axis)))
    for k, v in times.items():
        print(f"{k}: " + " ".join(f"{ms:.4f}" for ms in v) + f" ms (median "
              f"{statistics.median(v):.4f})", flush=True)


def run(route: str, cell: str, seed: int, trace: int, parent: Path,
        out_dir: Path) -> dict | None:
    args = ["--workload", cell, "--seed", str(seed), "--seconds", "10", "--trace", str(trace)]
    if route == "parent":
        cmd, cwd = [sys.executable, "perfbench/run.py", *args], parent
    elif route == "fused":
        cmd, cwd = [sys.executable, "perfbench/run.py", *args], REPO
    else:
        cmd, cwd = [sys.executable, "-c", CHILD, *args], REPO
    out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=900)
    (out_dir / f"{cell}_{route}_{seed}_{trace}.err").write_text(out.stderr[-20000:])
    lines = out.stdout.strip().splitlines()
    try:
        return json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        print(f"{route} {seed}: exit {out.returncode}, no result", flush=True)
        return None


def spread(v: list[float]) -> float:
    q = statistics.quantiles(v, n=4)
    return (q[2] - q[0]) / statistics.median(v)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", type=int, default=0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--routes", default="fused,attention_only")
    ap.add_argument("--parent", default="logs/parent")
    ap.add_argument("--cell", default="motionbert.video")
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="logs/route_ab")
    args = ap.parse_args()
    if args.kernels:
        time_kernels(args.kernels)
    if not args.seeds:
        return
    out_dir = REPO / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    routes = args.routes.split(",")
    got: dict[str, dict[int, dict]] = {r: {} for r in routes}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for route in routes[i % len(routes):] + routes[:i % len(routes)]:
            r = run(route, args.cell, seed, args.trace, REPO / args.parent, out_dir)
            with open(out_dir / f"{args.cell}_{args.trace}.jsonl", "a") as f:
                f.write(json.dumps({"route": route, "seed": seed, "result": r}) + "\n")
            if r is None:
                continue
            r["metrics"] = {k: v["value"] for k, v in r.get("metrics", {}).items()}
            got[route][seed] = r
            print(route, seed, "correct", r.get("correct"),
                  " ".join(f"{k}={v}" for k, v in r["metrics"].items()), flush=True)
    for route, runs in got.items():
        for k in METRICS:
            v = [r["metrics"][k] for r in runs.values() if k in r.get("metrics", {})]
            if len(v) >= 2:
                print(f"{route} {k}: median {statistics.median(v)}, spread {spread(v):.4f}, "
                      f"n {len(v)}, all correct {all(r.get('correct') for r in runs.values())}")
    for route in routes:
        if route == "fused":
            continue
        for k in METRICS[:3]:
            ratios = [got[route][s]["metrics"][k] / got["fused"][s]["metrics"][k]
                      for s in got[route] if s in got.get("fused", {})
                      and k in got[route][s]["metrics"] and k in got["fused"][s]["metrics"]]
            if ratios:
                print(f"{route} / fused {k}: " + " ".join(f"{q:.4f}" for q in ratios))


if __name__ == "__main__":
    main()
