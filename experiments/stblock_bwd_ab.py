"""A/B of the sub-block backward (``csrc/stblock_train.cu``) between source
trees, and between values of its split-K work-item count, on one card.

Each tree is a directory holding ``pose3d_tpu_torch`` and ``chip_smoke.py``:
``.`` is this checkout, another is a ``git archive`` of another commit under
the gitignored ``logs/``. For each tree, in the order given (give them as
parent, change, change, parent), a fresh process with that tree first on
``sys.path`` builds its kernels and, at 16 clips x 243 frames (66,096 token
rows, the first sub-block of the seeded default TemporalLifter, the
forward's own residuals): times one ``spatial_bwd``, one ``slab_bwd`` and
one ``sequences_bwd`` call (the joint-major layout of the same tokens; CUDA
events, the median of 3 runs of 20 back-to-back calls), lists
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
- mlp_noepi: ``mlp_bwd_kernel``'s epilogue (``mlp_gelu`` and ``mlp_dh``)
  returns at once;
- mlp_halfj: ``mlp_bwd_kernel``'s epilogue takes half its columns (half
  the work and half the code);
- mlp_nostore: ``mlp_bwd_kernel``'s epilogue stores neither hg nor dh (both
  still computed, packed and moved across the quad);
- mlp_noprod: ``mlp_bwd_kernel`` streams its ring but issues no product;
- mlp_serial: ``mlp_bwd_kernel`` issues g's product after ``mlp_gelu``, not
  before it, so a warpgroup's GELUs run beside no product of its own and
  hold 32 fewer accumulator registers (a design variant, right).

The two-warpgroup kernel's ``mlp_gelu2`` (the GELUs of two 8-column blocks
at once) is gone with it: at 128 registers a thread the four-warpgroup
kernel has no room for a second block's chains; its warps interleave
instead.

Each call's dx and dw are printed as SHA-256 digests of their bytes, so
that trees whose gradients are bitwise equal show equal digests.

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
import hashlib, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as C
from pose3d_tpu_torch.ops import _build, stblock as S, stblock_train as ST
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
    jm = lambda t: S.joint_major(t, C.TRAIN_CLIPS)  # noqa: E731
    for half, fwd, bwd, lay in (
            ("spatial", ST.spatial_fwd, ST.spatial_bwd, lambda t: t),
            ("temporal", ST.slab_fwd, ST.slab_bwd,
             lambda t: t.view(C.TRAIN_CLIPS, model.clip_len, 17 * 256)),
            ("temporal", ST.sequences_fwd, ST.sequences_bwd, jm)):
        w = ST.pack_train(model.blocks[0], half, torch.bfloat16)
        x, g = lay(tokens), lay(dout)
        _, x1, att = fwd(x, w)
        call = lambda: bwd(x, x1, att, g, w)  # noqa: E731
        out[bwd.__name__] = C.cuda_ms(call)
        out[bwd.__name__ + " sha256"] = [
            hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            for t in call()]
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
          f"slab_bwd {got['slab_bwd']:.4f} ms, sequences_bwd {got['sequences_bwd']:.4f} ms"
          + (f"; step {got['train_step']:.4f} ms, device {got['train_step device']:.4f} ms"
             if step else ""), flush=True)
    for k in ("spatial_bwd", "slab_bwd", "sequences_bwd"):
        print(f"   {k} sha256: dx {got[k + ' sha256'][0]}, dw {got[k + ' sha256'][1]}",
              flush=True)
        print(f"   {k} launches: " + ", ".join(f"{n} {ms}" for n, ms in got[k + " launches"]),
              flush=True)
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
    "mlp_noepi": [("bf16* __restrict__ hg, const bool (&live)[2], int q) {\n",
                   "bf16* __restrict__ hg, const bool (&live)[2], int q) {\n"
                   "  if (b1 != nullptr) return;\n"),
                  ("const bool (&live)[2]) {\n  float cs[8][2];\n",
                   "const bool (&live)[2]) {\n  if (dh != nullptr) return;\n  float cs[8][2];\n")],
    "mlp_halfj": [("  for (int j = 0; j < 8; ++j) {\n    const float2 bv",
                   "  for (int j = 0; j < 4; ++j) {\n    const float2 bv"),
                  ("    cs[j][0] = cs[j][1] = 0.f;\n",
                   "    cs[j][0] = cs[j][1] = 0.f;\n    if (j >= 4) continue;\n")],
    "mlp_nostore": [("  if (live) *reinterpret_cast<uint4*>(p + 8 * q) = make_uint4(w[0], w[1], w[2], w[3]);",
                     "  (void)p, (void)live;\n"
                     "  asm volatile(\"\" ::\"r\"(w[0]), \"r\"(w[1]), \"r\"(w[2]), \"r\"(w[3]));")],
    "mlp_noprod": [("    rt::wgmma_m64n64(acc, rt::desc_off(da, (j / 4) * rt::kKBlockBytes + (j % 4) * 32),\n"
                    "                     rt::desc_off(db, j * 2048), j);", "    (void)da, (void)db;"),
                   ("    rt::wgmma_m64n64<0, 0>(acc, rt::desc_off(da, k), rt::desc_off(db, k), j);",
                    "    (void)k;")],
    "mlp_serial": [("      issue_g(g, douta, acquire(e + 1));\n"
                    "      rt::wgmma_wait<1>();  // h is done; g's product runs on\n",
                    "      rt::wgmma_wait<0>();\n"),
                   ("      mlp_gelu(h, b1 + c * rt::kBox + 2 * q, hg + o + c * rt::kBox, live, q);\n"
                    "      rt::wgmma_wait<0>();\n",
                    "      mlp_gelu(h, b1 + c * rt::kBox + 2 * q, hg + o + c * rt::kBox, live, q);\n"
                    "      issue_g(g, douta, acquire(e + 1));\n      rt::wgmma_wait<0>();\n")],
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
