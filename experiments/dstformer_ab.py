"""A/B of DSTformer's fused sub-block launches (``csrc/dstformer.cu``)
between source variants, on one card.

Each tree is a directory holding ``pose3d_tpu_torch`` and ``chip_smoke.py``:
``.`` is this checkout; ``--variants a.cu,b.cu`` adds copies of it under
``logs/dstformer_ab/<name>/`` whose ``csrc/dstformer.cu`` is the file
given (a design variant). For each tree, in the order given (``--order``,
e.g. ``0,1,1,0``), a fresh process with that tree first on ``sys.path``
builds its kernels, prints ptxas' lines for ``gemm_kernel``, holds one
spatial and one temporal sub-block at 3 clips to the plain version
(chip_smoke's limits) and times at 16 clips x 243 frames (CUDA events,
the median of 3 runs of 20 calls): each launch, each sub-block, and the
module route's sub-block (the yardstick). Prints one JSON line a tree.

Run on the card from the repository root:
``python3 experiments/dstformer_ab.py --variants logs/variants/v2.cu --order 0,1,1,0``
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "logs" / "dstformer_ab"

CHILD = r'''
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as C
from pose3d_tpu_torch.ops import _build, dstformer as D

torch.backends.cuda.matmul.allow_tf32 = False
_build.library()
log = _build.build_log().splitlines()
for i, line in enumerate(log):
    if "Compiling entry" in line and "dstformer" in line:
        print("ptxas:", line.split("'")[1][:90], "|", " ".join(l.strip() for l in log[i + 1:i + 3]))
res = {"tree": sys.argv[1]}
with torch.inference_mode():
    m = C.seeded_dstformer("cuda", torch.bfloat16)
    x3 = C.dstformer_tokens(m, 3, 243, 77)
    for axis in ("s", "t"):
        w = D.weights(m.blocks_st[0], axis)
        got, want = D.sub_block(x3, w, axis, 243), D.sub_block_reference(x3, w, axis, 243)
        d = (got.float() - want.float()).abs()
        ex = float((d - (5e-2 + 2 ** -5 * want.float().abs())).max())
        res[f"check_{axis}"] = [float(d.max()), ex, bool(torch.equal(got, D.sub_block(x3, w, axis, 243)))]
    t = C.dstformer_timing_phase(m)
    res.update({k: round(v, 4) for k, v in t.items()})
print("RESULT", json.dumps(res), flush=True)
'''


def make_variant(src: Path) -> Path:
    dst = OUT / src.stem
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    shutil.copytree(REPO / "pose3d_tpu_torch", dst / "pose3d_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__", "*.so"))
    shutil.copy(REPO / "chip_smoke.py", dst / "chip_smoke.py")
    shutil.copy(src, dst / "pose3d_tpu_torch" / "csrc" / "dstformer.cu")
    return dst


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="")
    ap.add_argument("--order", default="0")
    args = ap.parse_args()
    trees = [REPO] + [make_variant(REPO / v) for v in args.variants.split(",") if v]
    for i in map(int, args.order.split(",")):
        tree = trees[i]
        out = subprocess.run([sys.executable, "-c", CHILD, str(tree.relative_to(REPO))],
                             cwd=tree, capture_output=True, text=True, timeout=1800)
        print(out.stdout[-6000:], flush=True)
        if out.returncode:
            print(f"tree {tree}: exit {out.returncode}\n{out.stderr[-4000:]}", flush=True)


if __name__ == "__main__":
    main()
