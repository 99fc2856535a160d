"""A/B of the sub-block backward (``csrc/stblock_train.cu``) between source
trees, and between values of its split-K work-item count, on one card.

Each tree is a directory holding ``pose3d_tpu_torch`` and ``chip_smoke.py``:
``.`` is this checkout, another is a ``git archive`` of another commit under
the gitignored ``logs/``. For each tree, in the order given (give them as
parent, change, change, parent), a fresh process with that tree first on
``sys.path`` builds its kernels and, at 16 clips x 243 frames (66,096 token
rows, the first sub-block of the seeded default TemporalLifter, the
forward's own residuals): times one ``spatial_bwd`` and one ``slab_bwd``
call (CUDA events, the median of 3 runs of 20 back-to-back calls), lists
each launch of one call with its device ms (torch.profiler) and, with
``--step``, times the whole training step and sums its device time by
kernel. The helpers are the tree's own ``chip_smoke.py``'s.

``--wgrad-items 66,132,264`` runs the same on copies of this checkout under
``logs/stblock_bwd_ab/`` whose ``kWgradItems`` (the weight gradients'
tiles x K slices) is each value in turn, after the trees. ``--variants
a,b`` runs copies whose ``stblock_train.cu`` is patched as VARIANTS says
(timing variants: their gradients are wrong), to split a launch's time
between its products and its epilogue:

- ln_noepi: ``ln_gemm_kernel`` stages its tile and skips the LayerNorm rows;
- ln_noprod: ``ln_gemm_kernel`` streams its ring but issues no product;
- ln_pf: ``ln_gemm_kernel``'s producer also prefetches each tile's src and
  resid rows into L2 while the tile's products run (a design variant, right);
- mlp_noepi: ``mlp_bwd_kernel``'s epilogue returns at once;
- mlp_halfj: ``mlp_bwd_kernel``'s epilogue takes half its columns (half
  the work and half the code);
- mlp_gelu2: ``mlp_bwd_kernel``'s epilogue takes the GELUs of two 8-column
  blocks together, not one (a design variant, right);
- mlp_nostore: ``mlp_bwd_kernel``'s epilogue stores neither hg nor dh (hg
  still computed, folded into the column sums);
- mlp_noprod: ``mlp_bwd_kernel`` streams its ring but issues no product.

Run on the card from the repository root:
``python3 experiments/stblock_bwd_ab.py --trees logs/parent,.,.,logs/parent --step``
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "logs" / "stblock_bwd_ab"

CHILD = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as C
from pose3d_tpu_torch.ops import _build, stblock_train as ST
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.steps import make_lifter_train_step

t0 = time.perf_counter()
_build.library()
out = {"tree": sys.argv[1], "build_s": round(time.perf_counter() - t0, 1)}
model = C.seeded_train_model()
y1, y2 = C.synthetic_batch(C.TRAIN_CLIPS, model.clip_len, C.SEED + 25)
with torch.no_grad():
    tokens = ST.embed_clips(model, y1, torch.bfloat16)
    dout = (torch.randn(tokens.shape, generator=torch.Generator().manual_seed(C.SEED + 26))
            * 2 ** -6).to("cuda", torch.bfloat16)
    for half, fwd, bwd, shape in (
            ("spatial", ST.spatial_fwd, ST.spatial_bwd, tokens.shape),
            ("temporal", ST.slab_fwd, ST.slab_bwd, (C.TRAIN_CLIPS, model.clip_len, 17 * 256))):
        w = ST.pack_train(model.blocks[0], half, torch.bfloat16)
        x, g = tokens.view(shape), dout.view(shape)
        _, x1, att = fwd(x, w)
        call = lambda: bwd(x, x1, att, g, w)  # noqa: E731
        out[bwd.__name__] = C.cuda_ms(call)
        out[bwd.__name__ + " launches"] = [(n.split("(")[0][:60], round(ms, 4))
                                          for n, ms in C.device_launches(call)]
if "--step" in sys.argv:
    state = create_train_state(model, lr=C.TRAIN_LR, apply=ST.temporal_train_forward_fused)
    step = make_lifter_train_step("mse")
    out["train_step"] = C.cuda_ms(lambda: step(state, y1, y2))
    split = C.device_ms_by_kernel(lambda: step(state, y1, y2), n=5)
    out["train_step device"] = sum(split.values())
    out["train_step top"] = [(n.split("(")[0][:60], round(ms, 4))
                             for n, ms in sorted(split.items(), key=lambda kv: -kv[1])[:12]]
print("AB " + json.dumps(out), flush=True)
'''


def run(tree: Path, label: str, step: bool) -> None:
    cmd = [sys.executable, "-c", CHILD, label] + (["--step"] if step else [])
    res = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
    if res.returncode != 0 or not lines:
        print(res.stdout[-4000:], res.stderr[-4000:], flush=True)
        raise SystemExit(f"{label}: exit {res.returncode}")
    got = json.loads(lines[-1][3:])
    print(f"== {label}: build {got['build_s']} s; spatial_bwd {got['spatial_bwd']:.4f} ms, "
          f"slab_bwd {got['slab_bwd']:.4f} ms"
          + (f"; step {got['train_step']:.4f} ms, device {got['train_step device']:.4f} ms"
             if step else ""), flush=True)
    for k in ("spatial_bwd launches", "slab_bwd launches"):
        print(f"   {k}: " + ", ".join(f"{n} {ms}" for n, ms in got[k]), flush=True)
    if step:
        print("   step top: " + ", ".join(f"{n} {ms}" for n, ms in got["train_step top"]),
              flush=True)


VARIANTS = {
    "ln_noepi": [("        __syncwarp();\n#pragma unroll 1\n",
                  "        __syncwarp();\n        if (K > 0) continue;\n#pragma unroll 1\n")],
    "ln_noprod": [("          rt::wgmma_m64n256<0, 0>(acc, rt::desc_a(s + wg * rt::kBoxBytes + j * 32),\n"
                   "                                  rt::desc_a(s + kABytes + j * 32), kc | j);",
                   "          ;")],
    "ln_pf": [("        const int m0 = tile * rt::kTileRows;\n",
               "        const int m0 = tile * rt::kTileRows, n = min(rt::kTileRows, n_rows - m0);\n"
               "        const size_t eb = kLn2 ? sizeof(bf16) : sizeof(float);\n"
               "        asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\" ::\"l\"(src + "
               "size_t(m0) * kDim), \"r\"(uint32_t(n * kDim * 2)) : \"memory\");\n"
               "        asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\" ::\"l\"("
               "static_cast<const unsigned char*>(resid) + size_t(m0) * kDim * eb), "
               "\"r\"(uint32_t(n * kDim * eb)) : \"memory\");\n")],
    "mlp_noepi": [("                                             int q) {\n  float cs[8][2] = {};",
                   "                                             int q) {\n  if (c >= 0) return;\n"
                   "  float cs[8][2] = {};")],
    "mlp_halfj": [("  for (int jb = 0; jb < 8; jb += kGeluBlocks) {",
                   "  for (int jb = 0; jb < 4; jb += kGeluBlocks) {")],
    "mlp_gelu2": [("constexpr int kGeluBlocks = 1;", "constexpr int kGeluBlocks = 2;")],
    "mlp_nostore": [("        if (live) {\n          const size_t o = size_t(r0 + ra + 8 * h) * kMlp + col;\n"
                     "          store2(hg + o, g[4 * u + 2 * h], g[4 * u + 2 * h + 1]);\n"
                     "          store2(dh + o, d0, d1);\n        }",
                     "        cs[j][0] += 1e-30f * (g[4 * u + 2 * h] + g[4 * u + 2 * h + 1]);")],
    "mlp_noprod": [("    rt::wgmma_m64n64(acc, rt::desc_a(a + (j / 4) * rt::kKBlockBytes + (j % 4) * 32),\n"
                    "                     rt::desc_b(b + j * 2048), j);", "    ;"),
                   ("    rt::wgmma_m64n64<0, 0>(acc, rt::desc_a(a + k), rt::desc_a(b + k), j);",
                    "    (void)k;")],
}


def patched_copy(label: str, patches: list[tuple[str, str]]) -> Path:
    """A copy of this checkout's package and script with each (old, new)
    text patch applied once to csrc/stblock_train.cu."""
    dst = OUT / label
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(REPO / "pose3d_tpu_torch", dst / "pose3d_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__", "*.so"))
    shutil.copy(REPO / "chip_smoke.py", dst / "chip_smoke.py")
    cu = dst / "pose3d_tpu_torch" / "csrc" / "stblock_train.cu"
    text = cu.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{label}: the patched text is not in stblock_train.cu once")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst


def items_copy(n: int) -> Path:
    """A copy of this checkout's package and script with kWgradItems = n."""
    src = (REPO / "pose3d_tpu_torch" / "csrc" / "stblock_train.cu").read_text()
    old = re.search(r"constexpr int kWgradItems = \d+;", src)
    if old is None:
        raise SystemExit("kWgradItems not found in stblock_train.cu")
    return patched_copy(f"items{n}", [(old.group(0), f"constexpr int kWgradItems = {n};")])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", default=".")
    ap.add_argument("--wgrad-items", default="")
    ap.add_argument("--variants", default="")
    ap.add_argument("--step", action="store_true")
    args = ap.parse_args()
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   check=True)
    for tree in args.trees.split(","):
        run((REPO / tree).resolve(), tree, args.step)
    for n in filter(None, args.wgrad_items.split(",")):
        run(items_copy(int(n)), f"kWgradItems={n}", False)
    for name in filter(None, args.variants.split(",")):
        run(patched_copy(name, VARIANTS[name]), name, False)


if __name__ == "__main__":
    main()
