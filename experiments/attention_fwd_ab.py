"""A/B of the attention forward (``csrc/attention.cu``) between source
trees, on one card.

Each tree is a directory holding ``pose3d_tpu_torch`` and ``chip_smoke.py``:
``.`` is this checkout, another is a ``git archive`` of another commit under
the gitignored ``logs/``. For each tree, in the order given (give them as
parent, change, change, parent), a fresh process with that tree first on
``sys.path`` builds its kernels and times, with the tree's own
``chip_smoke.py`` helpers (CUDA events, the median of 3 runs of 20
back-to-back calls; device ms from torch.profiler):

- ``seq_attention`` at 272 sequences x 243 frames x 8 heads x 32 (row 4),
  at L = 100 and 256 (272 sequences) and at L = 1440 (34 sequences), each
  beside PyTorch's ``scaled_dot_product_attention`` on the same head-split
  inputs (a yardstick; the port never calls it);
- ``packed_flat_attention`` at 66,096 rows of 17 (row 3, the L <= 64 kernel);
- the attention launch inside the temporal sub-block forwards at 16 clips x
  243 frames: the slab (``temporal_slab``, ``slab_fwd``) and the
  joint-major layout (``temporal_block_fused``), by device ms;
- the fused temporal forward at 16 x 243 (and its device time),
  ``lift_sequence`` on a 600-frame video host to host, and the training
  step at 16 clips (its device time summed by kernel).

``--variants a,b`` then runs copies of this checkout under
``logs/attention_fwd_ab/`` whose ``csrc/attention.cu`` is patched as
VARIANTS says (design variants, each right), timing the attention alone
(the first two items):

- ring64k: a K/V ring of 64 KB (4 stages of 128 keys at dh = 32) in
  place of 160 KB;
- slots4: four Q slots in place of two;
- skew1000, skew2000, skew3000: the second consumer warpgroup starts that
  many cycles after the first, so that one's exponentials may fall in the
  other's waits.

Run on the card from the repository root, the parent a ``git archive`` of
``pose3d_tpu_torch`` and ``chip_smoke.py`` under ``logs/parent``:
``python3 experiments/attention_fwd_ab.py --trees logs/parent,.,.,logs/parent``
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "logs" / "attention_fwd_ab"

CHILD = r'''
import json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as C
from pose3d_tpu_torch.ops import _build, attention as A, stblock as S, stblock_train as ST
from pose3d_tpu_torch.pipeline.lift import lift_sequence
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.steps import make_lifter_train_step

t0 = time.perf_counter()
_build.library()
out = {"tree": sys.argv[1], "build_s": round(time.perf_counter() - t0, 1)}
sdpa = torch.nn.functional.scaled_dot_product_attention
gen = torch.Generator().manual_seed(C.SEED + 9)


def heads_split(qkv, length):  # (N, L, 3*256) -> 3 x (N, 8, L, 32), contiguous
    q, k, v = qkv.view(-1, length, 3, 8, 32).permute(2, 0, 3, 1, 4)
    return q.contiguous(), k.contiguous(), v.contiguous()


with torch.inference_mode():
    for n, length in ((272, 243), (272, 100), (272, 256), (34, 1440)):
        qkv = torch.randn(n, length, 768, generator=gen).to("cuda", torch.bfloat16)
        q, k, v = heads_split(qkv, length)
        out[f"seq_attention {n} x {length}"] = C.cuda_ms(lambda: A.seq_attention(qkv, 8))
        out[f"sdpa {n} x {length}"] = C.cuda_ms(lambda: sdpa(q, k, v))
    quick = "--quick" in sys.argv
    packed = torch.randn(16 * 243 * 17, 768, generator=gen).to("cuda", torch.bfloat16)
    out["packed_flat_attention 66096 x 17"] = C.cuda_ms(
        lambda: A.packed_flat_attention(packed, 17, 8))

    model = C.seeded_temporal("cuda", torch.bfloat16)
    kp = C.seeded_clips(C.CLIPS, model, C.SEED + 8)
    weights = S.pack_temporal_lifter(model)
    wt = weights[0][1]
    slab = S.embed_clips(model, kp).view(C.CLIPS, model.clip_len, -1)
    seqs = S.joint_major(slab.reshape(-1, 256), C.CLIPS)
    for name, fn in (("temporal_slab", lambda: S.temporal_slab(slab, wt)),
                     ("slab_fwd", lambda: ST.slab_fwd(slab, wt)),
                     ("temporal_block_fused", lambda: S.temporal_block_fused(seqs, wt))):
        out[f"{name} launches"] = [(k.split("(")[0][:48], round(ms, 4))
                                   for k, ms in C.device_launches(fn, expected=3)]
    if not quick:
        fused = lambda: S.temporal_forward_fused(model, kp, weights=weights)  # noqa: E731
        out["fused_forward"] = C.cuda_ms(fused)
        out["fused_forward device"] = sum(C.device_ms_by_kernel(fused, n=5).values())
        video = (np.random.default_rng(C.SEED + 10).random((600, 17, 2)) * 1000).astype(
            np.float32)
        out["lift_sequence 600"] = C.cuda_ms(lambda: lift_sequence(model, video))

if not quick:
    train_model = C.seeded_train_model()
    y1, y2 = C.synthetic_batch(C.TRAIN_CLIPS, train_model.clip_len, C.SEED + 25)
    state = create_train_state(train_model, lr=C.TRAIN_LR,
                               apply=ST.temporal_train_forward_fused)
    step = make_lifter_train_step("mse")
    out["train_step"] = C.cuda_ms(lambda: step(state, y1, y2))
    out["train_step device"] = sum(
        C.device_ms_by_kernel(lambda: step(state, y1, y2), n=5).values())
print("AB " + json.dumps(out), flush=True)
'''


def run(tree: Path, label: str, quick: bool = False) -> None:
    res = subprocess.run([sys.executable, "-c", CHILD, label] + (["--quick"] if quick else []),
                         cwd=tree, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
    if res.returncode != 0 or not lines:
        print(res.stdout[-4000:], res.stderr[-4000:], flush=True)
        raise SystemExit(f"{label}: exit {res.returncode}")
    got = json.loads(lines[-1][3:])
    print(f"== {label}: build {got.pop('build_s')} s", flush=True)
    for k, v in got.items():
        if k != "tree":
            print(f"   {k}: " + (", ".join(f"{n} {ms}" for n, ms in v) if isinstance(v, list)
                                 else f"{v:.4f} ms"), flush=True)


VARIANTS = {
    "ring64k": [("constexpr int kWgRingBytes = 160 * 1024;",
                 "constexpr int kWgRingBytes = 64 * 1024;")],
    "slots4": [("constexpr int kWgSlots = 2;", "constexpr int kWgSlots = 4;")],
}
for _cycles in (1000, 2000, 3000):
    VARIANTS[f"skew{_cycles}"] = [(
        "  rt::regs_inc<rt::kConsumerRegs>();\n  const int lane",
        "  rt::regs_inc<rt::kConsumerRegs>();\n"
        f"  for (const long long t0 = clock64(); wg == 1 && clock64() - t0 < {_cycles};) {{}}\n"
        "  const int lane")]


def patched_copy(label: str, patches: list[tuple[str, str]]) -> Path:
    """A copy of this checkout's package and script with each (old, new)
    text patch applied once to csrc/attention.cu."""
    dst = OUT / label
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(REPO / "pose3d_tpu_torch", dst / "pose3d_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__", "*.so"))
    shutil.copy(REPO / "chip_smoke.py", dst / "chip_smoke.py")
    cu = dst / "pose3d_tpu_torch" / "csrc" / "attention.cu"
    text = cu.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{label}: the patched text is not in attention.cu once")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", default=".")
    ap.add_argument("--variants", default="")
    ap.add_argument("--quick", action="store_true", help="the attention alone for every tree")
    args = ap.parse_args()
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   check=True)
    for tree in filter(None, args.trees.split(",")):
        run((REPO / tree).resolve(), tree, args.quick)
    for name in filter(None, args.variants.split(",")):
        run(patched_copy(name, VARIANTS[name]), name, quick=True)


if __name__ == "__main__":
    main()
