"""Where does a 128-row tile of the sub-block forward kernels spend its time?

Copies ``pose3d_tpu_torch`` to ``logs/phase_stamps/`` (gitignored), adds
clock64 stamps to the copy's ``csrc/stblock.cu`` after each phase of
``qkv_kernel`` and ``rest_kernel`` (thread 0 of each consumer warpgroup,
the first 4 tiles of each of the first 132 CTAs) and sums each consumer
warpgroup's waits on full ring stages, then runs the copy's slab sub-block
at 16 clips x 243 frames (66,096 rows) on the card and prints the mean
cycles of each phase a tile. ``--no-row-loads`` replaces qkv_kernel's x
row loads by constants (its output is then wrong: a timing variant only).

Phases: qkv_kernel: LN_1 (x rows in, y into A); then per pass of q|k|v
the products and the staged TMA store. rest_kernel: attention rows into A;
the projection; x1 + LN_2; the first W1 chunk and its GELU; the 15 MLP
steps; the last residual.

Run on the card from the repository root:
``python3 experiments/stblock_phase_stamps.py [--no-row-loads]``
"""

from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "logs" / "phase_stamps"

STAMPS = '''
__device__ long long g_stamp[2][132][2][4][16];  // kernel, CTA, consumer wg, tile, phase
__device__ long long g_wait[2][132][2][4];
extern "C" int stblock_debug_read(void* stamps, void* waits) {
  cudaMemcpyFromSymbol(stamps, g_stamp, sizeof(g_stamp));
  return cudaMemcpyFromSymbol(waits, g_wait, sizeof(g_wait));
}
#define STAMP(K, slot) do { if (threadIdx.x % 128 == 0 && blockIdx.x < 132 && it < 4) \\
  g_stamp[K][blockIdx.x][wg][it][slot] = clock64(); } while (0)
#define WAITS(K) do { if (threadIdx.x % 128 == 0 && blockIdx.x < 132 && it < 4) \\
  g_wait[K][blockIdx.x][wg][it] = ring.waited; } while (0)
'''


def instrument(no_row_loads: bool) -> Path:
    """The instrumented copy of the package; returns its parent directory."""
    shutil.rmtree(OUT, ignore_errors=True)
    pkg = OUT / "pose3d_tpu_torch"
    shutil.copytree(REPO / "pose3d_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    engine = pkg / "csrc" / "rowtile_sm90.cuh"
    s = engine.read_text()
    for old, new in (
            ("  int next;  // chunks taken so far\n",
             "  int next;  // chunks taken so far\n  long long waited = 0;\n"),
            ("    mbar_wait(full(s), (next / kStages) & 1);\n",
             "    { const long long t = clock64(); mbar_wait(full(s), (next / kStages) & 1);"
             " waited += clock64() - t; }\n")):
        if s.count(old) != 1:
            raise SystemExit(f"rowtile_sm90.cuh has changed: {old.strip()!r}")
        s = s.replace(old, new)
    engine.write_text(s)

    src = pkg / "csrc" / "stblock.cu"
    lines = src.read_text().split("\n")

    def find(anchor: str, start: int) -> int:
        for i in range(start, len(lines)):
            if anchor in lines[i]:
                return i
        raise SystemExit(f"stblock.cu has changed: no {anchor!r}")

    inserts = []  # (line index, text inserted after it)
    for kernel, first in ((0, "qkv_kernel(const __grid_constant__"),
                          (1, "rest_kernel(const __grid_constant__")):
        k = find(first, 0)
        consumer = find("rt::regs_inc", k)
        tile = find("for (int tile = blockIdx.x", consumer)
        inserts += [(consumer, "    int it = -1;"), (tile, f"      ++it; STAMP({kernel}, 0);")]
        if kernel == 0:
            loads = find("load_rows(xv, x, r0, rows, warp, lane);", tile)
            if no_row_loads:
                lines[loads] = ("      for (int i = 0; i < 16; ++i) "
                                "xv[i] = make_uint4(0x3f803f80u + i, lane, 0, warp);")
            i = find("rt::wg_sync(wg);", loads)
            inserts.append((i, "      STAMP(0, 1);"))
            i = find("rt::gemm_wide", i)
            inserts.append((i, "        STAMP(0, 2 + 2 * pass);"))
            i = find("rt::tma_store_commit();", i)
            inserts.append((i + 1, "        STAMP(0, 3 + 2 * pass);"))
            i = find("    if (issuer) rt::tma_store_wait();", i)
            inserts.append((i - 2, "      WAITS(0);"))
        else:
            i = find("rt::wg_sync(wg);", tile)
            inserts.append((i, "      STAMP(1, 1);"))
            for n, anchor in enumerate(("stage_acc(acc, a, weights + kOffBProj",
                                        "rt::wg_sync(wg);", "      int w_prev = -1;",
                                        "      rt::fence_acc(acc);"), start=2):
                i = find(anchor, i)
                inserts.append((i, f"      STAMP(1, {n});"))
            i = find("if (r < rows) st16(out", i)
            inserts.append((i + 1, "      STAMP(1, 6); WAITS(1);"))
    for i, text in sorted(inserts, reverse=True):
        lines.insert(i + 1, text)
    s = "\n".join(lines)
    anchor = "namespace {\n\nusing namespace pose3d;"
    if s.count(anchor) != 1:
        raise SystemExit("stblock.cu has changed: no anonymous namespace to precede")
    src.write_text(s.replace(anchor, STAMPS + anchor))
    return OUT


def main() -> None:
    root = instrument("--no-row-loads" in sys.argv[1:])
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import pose3d_tpu_torch
    from pose3d_tpu_torch.models.temporal import TemporalLifter
    from pose3d_tpu_torch.ops import _build
    from pose3d_tpu_torch.ops import stblock as S
    from pose3d_tpu_torch.ops import stblock_train as ST

    if Path(pose3d_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit("the instrumented copy was not imported")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(torch.cuda.get_device_name(0))
    lib = _build.library()
    lib.stblock_debug_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    model = TemporalLifter(device="cpu").init_weights(torch.Generator().manual_seed(0))
    w = ST.pack_train(model.to("cuda").blocks[0], "temporal", torch.bfloat16)
    slab = torch.randn(16 * 243 * 17, 256, generator=torch.Generator().manual_seed(1)).to(
        "cuda", torch.bfloat16).view(16, 243, -1)
    for _ in range(4):
        S.temporal_slab(slab, w)
    torch.cuda.synchronize()
    stamps = np.zeros((2, 132, 2, 4, 16), np.int64)
    waits = np.zeros((2, 132, 2, 4), np.int64)
    lib.stblock_debug_read(stamps.ctypes.data, waits.ctypes.data)
    for k, name, phases in ((0, "qkv_kernel", 8), (1, "rest_kernel", 7)):
        d = np.diff(stamps[k, :, :, :3, :phases], axis=-1).reshape(-1, phases - 1)
        period = np.diff(stamps[k, :, :, :3, 0], axis=-1).mean()
        w8 = np.diff(np.concatenate([np.zeros((132, 2, 1), np.int64), waits[k, :, :, :3]], -1))
        print(f"{name}: cycles a tile by phase {np.round(d.mean(0)).astype(int).tolist()}, "
              f"tile period {period:.0f}, waits on full stages "
              f"{np.round(w8.mean((0, 1))).astype(int).tolist()} (tiles 0-2)")


if __name__ == "__main__":
    main()
