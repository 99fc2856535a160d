"""Where does a work item of the attention kernel for L > 64
(``attention_wg_kernel``, ``csrc/attention.cu``) spend its time?

Copies ``pose3d_tpu_torch/csrc`` to ``logs/attention_stamps/``, adds clock64
stamps to the copy's ``attention.cu`` after each phase of a consumer
warpgroup's work item, builds that file alone into a library (nvcc, the
port's flags) beside an unstamped build of the same file, and runs both on
seeded bf16 rows through ``attention_launch`` at 272 sequences x L x 8
heads x 32 (L = 243 and 100 by default), printing each phase's mean
cycles an item (over the first thread of each consumer warpgroup of
every CTA), the items a CTA, and the kernels' ms with and without the
stamps. Every thread reads the clock (no branch between a product's issue
and its wait). A stamp orders nothing: where a product's result is read
only in a later phase, that phase takes its wait.

Phases: S0wait (the wait for the item's first S, which went out beside
the last item's last P V), exp0 (its exponentials and A fragments), then
for each later tile S (its stage, its S and the last tile's P V issued, S
waited for), exp (its exponentials), PV (the last P V waited for, the
stage handed back, A fragments); next (the next item's Q and first stage,
this item's last P V and the next item's first S issued); PVwait (the
row sums, their inverses and the rows' addresses, and the wait for that
P V); rows (the output stores).

Run on the card from the repository root:
``python3 experiments/attention_phase_stamps.py [--lengths 243,100]``
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "logs" / "attention_stamps"
N_SEQ, HEADS, DH = 272, 8, 32
PHASES = ("S0wait", "exp0", "S", "exp", "PV", "next", "PVwait", "rows")
N = len(PHASES)

STAMPS = f'''
__device__ long long g_attn_stamps[132][2][{N + 1}];  // CTA, warpgroup, phases + items
extern "C" int attn_stamps_read(void* out) {{
  return cudaMemcpyFromSymbol(out, g_attn_stamps, sizeof(g_attn_stamps));
}}
extern "C" int attn_stamps_clear() {{
  static long long zero[132][2][{N + 1}];
  return cudaMemcpyToSymbol(g_attn_stamps, zero, sizeof(zero));
}}
#define FS_DECL long long fs_ph[{N}] = {{}}, fs_t = clock64(), fs_n = 0;
#define FS(k) do {{ const long long c_ = clock64(); fs_ph[k] += c_ - fs_t; fs_t = c_; }} while (0)
#define FS_SAVE do {{ if (threadIdx.x % 128 == 0 && blockIdx.x < 132) {{ \\
  for (int i_ = 0; i_ < {N}; ++i_) g_attn_stamps[blockIdx.x][threadIdx.x / 128][i_] = fs_ph[i_]; \\
  g_attn_stamps[blockIdx.x][threadIdx.x / 128][{N}] = fs_n; }} }} while (0)
'''

# (anchor in attention_wg_kernel's consumer code, text inserted after it)
INSERTS = [
    ("  constexpr float sl = attn::head_scale<DH>() * kLog2e;\n", "  FS_DECL\n"),
    ("    float l0 = 0.f, l1 = 0.f;\n    rt::wgmma_wait<0>();\n    rt::fence_acc(s);\n",
     "    FS(0); ++fs_n;\n"),
    ("    clamped_exp<kN>(s, sl, L, q4, l0, l1);\n    attn::to_frags<kN>(s, p);\n", "    FS(1);\n"),
    ("      rt::wgmma_wait<1>();  // S has landed; P V runs under the exps\n      rt::fence_acc(s);\n",
     "      FS(2);\n"),
    ("      clamped_exp<kN>(s, sl, L - kt * kN, q4, l0, l1);\n", "      FS(3);\n"),
    ("      attn::to_frags<kN>(s, p);\n      kv = next;\n", "      FS(4);\n"),
    ("    attn::issue_scores<DH, kN>(s, dn, kn);  // the next item's first S\n"
     "    rt::wgmma_commit();\n", "    FS(5);\n"),
    ("    if (more) ring.release(ring.next - 2);\n", "    FS(6);\n"),
    ("    qa = qn;\n    kv = kn;\n", "    FS(7);\n"),
    ("  rt::wgmma_wait<0>();  // the phantom S\n  rt::fence_acc(s);\n", "  FS_SAVE;\n"),
]


def stamped_copy() -> tuple[Path, Path]:
    """(the stamped attention.cu, a plain copy of it), each in its own
    copy of csrc under OUT."""
    paths = []
    for name in ("stamped", "plain"):
        dst = OUT / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(REPO / "pose3d_tpu_torch" / "csrc", dst)
        paths.append(dst / "attention.cu")
    src = paths[0].read_text()
    at = src.index("namespace {\n")  # the stamps' C functions need external linkage
    src = src[:at] + STAMPS + src[at:]
    for anchor, text in INSERTS:
        if src.count(anchor) != 1:
            raise SystemExit(f"the anchor is not in attention.cu once: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    paths[0].write_text(src)
    return paths[0], paths[1]


def build(src: Path) -> ctypes.CDLL:
    sys.path.insert(0, str(REPO))
    from pose3d_tpu_torch.ops import _build

    so = src.with_suffix(".so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-shared",
                          "-o", str(so), str(src)], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(res.stdout + res.stderr)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attention_launch.argtypes = [p, p, i, i, i, i, p]
    return lib


def main() -> None:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--lengths", default="243,100")
    args = ap.parse_args()
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                    "--format=csv,noheader"], check=True)
    stamped_src, plain_src = stamped_copy()
    libs = {"stamped": build(stamped_src), "plain": build(plain_src)}
    gen = torch.Generator().manual_seed(0)
    for length in map(int, args.lengths.split(",")):
        qkv = torch.randn(N_SEQ, length, 3 * HEADS * DH, generator=gen).to("cuda", torch.bfloat16)
        outs = {}
        for name, lib in libs.items():
            out = torch.empty(N_SEQ, length, HEADS * DH, dtype=torch.bfloat16, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                err = lib.attention_launch(qkv.data_ptr(), out.data_ptr(), N_SEQ, length, HEADS,
                                           DH, stream)
                if err:
                    raise SystemExit(f"{name}: attention_launch returned {err}")

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                call()
            b.record()
            b.synchronize()
            outs[name] = out.clone()
            print(f"L = {length}, {name}: {a.elapsed_time(b) / 20:.4f} ms", flush=True)
            if name == "stamped":
                lib.attn_stamps_clear()
                call()
                torch.cuda.synchronize()
                stamps = np.zeros((132, 2, N + 1), np.int64)
                lib.attn_stamps_read.argtypes = [ctypes.c_void_p]
                lib.attn_stamps_read(stamps.ctypes.data)
                items = stamps[..., N].astype(np.float64)
                per = stamps[..., :N].sum(axis=(0, 1)) / items.sum()
                print(f"   items a warpgroup {items.mean():.2f}; cycles an item: "
                      + ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, per))
                      + f"; total {per.sum():.0f}", flush=True)
        if not torch.equal(outs["stamped"], outs["plain"]):
            raise SystemExit("the stamped kernel's output differs from the plain build's")


if __name__ == "__main__":
    main()
