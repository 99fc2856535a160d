"""Where does a tile of flash attention's kernels (14a, 14b, 14c) spend its time?

Copies ``pose3d_tpu_torch/csrc`` (or, with ``--old DIR``, ``DIR/pose3d_tpu_torch/csrc``
of another tree, e.g. a ``git archive`` of an older commit unpacked under the
gitignored ``logs/``) to ``logs/flash_stamps/<name>/``, adds clock64 stamps to the
copy's ``flash_attention.cu`` after each phase of a tile in ``flash_fwd_kernel``
(14a), ``flash_dq_kernel`` (14c) and ``flash_dkv_kernel`` (14b), builds that file
alone into a library (nvcc, the port's flags), and runs the kernels on seeded bf16
rows at the long-clip shape, 34 sequences x 2048 frames x 8 heads x 32, printing
the mean cycles a tile of each phase and the kernels' ms with and without the
stamps. Every thread reads the clock (no branch between a product's issue and its
wait); the first thread of each consumer warpgroup (of each 128 threads in a first
version's block) in the first 132 CTAs saves its sums. A stamp orders nothing:
where a product's result is read only in a later phase, that phase takes its wait.

Each kernel's design is read from the copy: the redesigns take their CUtensorMaps as
``__grid_constant__`` arguments, the first versions (mma.sync on cp.async tiles) do
not. Phases of the redesigns (wgmma fed by a TMA ring; 14a: tiles 2..n of a work
tile, 14c and 14b: every tile): 14a: ring wait, S product (with the last tile's P V
issued), softmax, P V tail, rescale + convert. 14c: S wait (the last tile's dS K
and this S), exponentials, dP wait, dS + convert, then dS K, the ring wait and the
next S and dP issued as one phase. 14b (a 64-key x 64-query tile of a warpgroup):
S^T wait, exponentials, dP^T wait, P converted with dV issued and dS formed and
converted, dK issued, the ring wait, the next S^T and dP^T issued, the wait for
dV and dK (the last tile's tail falls in this phase too). Phases of the
first versions: 14a: wait (cp.async + barrier), S product, softmax, P V (+
barrier); 14c: wait, S and dP products, exponentials + dS, dS K (+ barrier); 14b:
wait, S^T and dP^T products, exponentials + dS, dV and dK (+ barrier).

Run on the card from the repository root:
``python3 experiments/flash_phase_stamps.py [--old DIR]``
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "logs" / "flash_stamps"
N_SEQ, LENGTH, HEADS, DH = 34, 2048, 8, 32
KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")

STAMPS = '''
__device__ long long g_flash_stamps[3][132][2][9];  // kernel, CTA, warpgroup, phases + tiles
extern "C" int flash_stamps_read(void* out) {
  return cudaMemcpyFromSymbol(out, g_flash_stamps, sizeof(g_flash_stamps));
}
#define FS_DECL long long fs_ph[8] = {0, 0, 0, 0, 0, 0, 0, 0}, fs_t = 0, fs_n = 0; \\
  const bool fs_on = threadIdx.x % 128 == 0 && blockIdx.x < 132;
#define FS_START do { fs_t = clock64(); } while (0)
#define FS(k) do { const long long c_ = clock64(); fs_ph[k] += c_ - fs_t; fs_t = c_; } while (0)
#define FS_TILE do { ++fs_n; } while (0)
#define FS_SAVE(K) do { if (fs_on) { for (int i_ = 0; i_ < 8; ++i_) \\
  g_flash_stamps[K][blockIdx.x][threadIdx.x / 128 % 2][i_] = fs_ph[i_]; \\
  g_flash_stamps[K][blockIdx.x][threadIdx.x / 128 % 2][8] = fs_n; } } while (0)
'''

# kernel -> design -> (anchor, after: True inserts after the anchor's line, False
# before it, text); each anchor is searched from the previous one's line on.
ANCHORS = {
    "flash_fwd_kernel": {
        "wgmma": (
            ("rt::regs_inc<", True, "  FS_DECL"),
            ("for (int kt = 1; kt < n_kt; ++kt) {", True, "      FS_START;"),
            ("const uint32_t next = ring.acquire();", True, "      FS(0);"),
            ("rt::wgmma_wait<1>();", True, "      FS(1);"),
            ("online_softmax<kN>(s, sl, Lk - kt * kN", True, "      FS(2);"),
            ("rt::wgmma_wait<0>();", True, "      FS(3);"),
            ("kv = next;", True, "      FS(4); FS_TILE;"),
            ("slots.release(slots.next - 1);", True, "    FS_SAVE(0);"),
        ),
        "mma.sync": (
            ("const unsigned ro = rows_offset<DH>(lane)", True, "  FS_DECL"),
            ("for (int kt = 0; kt < n_kt; ++kt) {", True, "    FS_START;"),
            ("__syncthreads();", True, "    FS(0);"),
            ("tile_scores<DH>(qa,", True, "    FS(1);"),
            ("tile_accumulate<DH>(s,", False, "    FS(2);"),
            ("__syncthreads();", True, "    FS(3); FS_TILE;"),
            ("l0 = quad_sum(l0);", False, "  FS_SAVE(0);"),
        ),
    },
    "flash_dq_kernel": {
        "wgmma": (
            ("rt::regs_inc<", True, "  FS_DECL"),
            ("auto step = [&]", True, "      FS_START;"),
            ("rt::wgmma_wait<1>();", True, "      FS(0);"),
            ("= ex2(fmaf(", True, "      FS(1);"),
            ("rt::wgmma_wait<0>();", True, "      FS(2);"),
            ("to_frags<kN>(s, ds);", True, "      FS(3);"),
            ("    };", False, "      FS(4); FS_TILE;"),
            ("slots.release(slots.next - 1);", True, "    FS_SAVE(1);"),
        ),
        "mma.sync": (
            ("const unsigned ro = rows_offset<DH>(lane)", True, "  FS_DECL"),
            ("for (int kt = 0; kt < n_kt; ++kt) {", True, "    FS_START;"),
            ("__syncthreads();", True, "    FS(0);"),
            ("tile_scores<DH>(da,", True, "    FS(1);"),
            ("tile_accumulate<DH>(s,", False, "    FS(2);"),
            ("__syncthreads();", True, "    FS(3); FS_TILE;"),
            ("constexpr float sc = head_scale<DH>();", False, "  FS_SAVE(1);"),
        ),
    },
    "flash_dkv_kernel": {
        "wgmma": (
            ("rt::regs_inc<", True, "  FS_DECL"),
            ("uint32_t qd = ring.acquire();", True, "    FS_START;"),
            ("rt::wgmma_wait<1>();", True, "      FS(0);"),
            ("rt::wgmma_wait<0>();", False, "      FS(1);"),
            ("rt::wgmma_wait<0>();", True, "      FS(2);"),
            ("to_frags<kN>(s, ds);", True, "      FS(3);"),
            ("issue_rows<DH, kN>(dka, ds, qd);", True, ""),
            ("rt::wgmma_commit();", True, "      FS(4);"),
            ("qd = ring.acquire();", True, "        FS(5);"),
            ("rt::wgmma_wait<2>();", False, "        FS(6);"),
            ("rt::wgmma_wait<2>();", True, "        FS(7);"),
            ("    };", False, "      FS(7); FS_TILE;"),
            ("slots.release(slots.next - 1);", True, "    FS_SAVE(2);"),
        ),
        "mma.sync": (
            ("const unsigned ro = rows_offset<DH>(lane)", True, "  FS_DECL"),
            ("for (int t = 0; t < n_qt; ++t) {", True, "    FS_START;"),
            ("__syncthreads();", True, "    FS(0);"),
            ("tile_scores<DH>(va,", True, "    FS(1);"),
            ("tile_accumulate<DH>(s,", False, "    FS(2);"),
            ("__syncthreads();", True, "    FS(3); FS_TILE;"),
            ("constexpr float sc = head_scale<DH>();", False, "  FS_SAVE(2);"),
        ),
    },
}
PHASES = {
    ("flash_fwd_kernel", "wgmma"): ("ring wait", "S product", "softmax", "P V tail",
                                    "rescale + convert"),
    ("flash_dq_kernel", "wgmma"): ("S wait", "exponentials", "dP wait", "dS + convert",
                                   "dS K, ring wait, S and dP issued"),
    ("flash_dkv_kernel", "wgmma"): ("S^T wait", "exponentials", "dP^T wait",
                                    "P convert, dV issued, dS + convert", "dK issued",
                                    "ring wait", "S^T and dP^T issued", "dV and dK wait"),
    ("flash_fwd_kernel", "mma.sync"): ("wait", "S product", "softmax", "P V"),
    ("flash_dq_kernel", "mma.sync"): ("wait", "S, dP products", "exponentials + dS", "dS K"),
    ("flash_dkv_kernel", "mma.sync"): ("wait", "S^T, dP^T products", "exponentials + dS",
                                       "dV and dK"),
}


def design(lines: list[str], kernel: str) -> str:
    """'wgmma' where the kernel takes TMA maps as grid constants, else 'mma.sync'."""
    start = next(line for line in lines if line.startswith(kernel + "("))
    return "wgmma" if start.startswith(f"{kernel}(const __grid_constant__") else "mma.sync"


def instrument(csrc: Path, name: str) -> tuple[Path, dict[str, str]]:
    """The instrumented copy of csrc's flash_attention.cu and each kernel's design."""
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    src = dst / "flash_attention.cu"
    lines = src.read_text().split("\n")
    designs = {kernel: design(lines, kernel) for kernel in KERNELS}
    inserts = []
    for kernel in KERNELS:
        i = next(n for n, line in enumerate(lines) if line.startswith(kernel + "("))
        for anchor, after, text in ANCHORS[kernel][designs[kernel]]:
            i = next((n for n in range(i, len(lines)) if anchor in lines[n]), None)
            if i is None:
                raise SystemExit(f"{src.name} has changed: no {anchor!r} in {kernel}")
            if text:
                inserts.append((i + 1 if after else i, text))
            i += after  # the next anchor starts on the next line
    for i, text in sorted(inserts, reverse=True):
        lines.insert(i, text)
    s = "\n".join(lines)
    anchor = "namespace {\n"
    if s.count(anchor) != 1:
        raise SystemExit("flash_attention.cu has changed: no anonymous namespace to precede")
    src.write_text(s.replace(anchor, STAMPS + anchor))
    return src, designs


def build(src: Path, dq_pointers: int) -> ctypes.CDLL:
    sys.path.insert(0, str(REPO))
    from pose3d_tpu_torch.ops import _build

    so = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-shared", "-o",
                    str(so), str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_fwd_launch.argtypes = [p] * 3 + [ll] * 4 + [p, p] + [i] * 5 + [p]
    lib.flash_bwd_dq_launch.argtypes = [p] * 3 + [ll] * 4 + [p] * dq_pointers + [i] * 5 + [p]
    lib.flash_bwd_dkv_launch.argtypes = [p] * 3 + [ll] * 4 + [p] * 5 + [i] * 5 + [p]
    return lib


def main() -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from pose3d_tpu_torch.ops import flash_attention as F

    args = sys.argv[1:]
    old = args[:1] == ["--old"]
    csrc = (Path(args[1]).resolve() if old else REPO) / "pose3d_tpu_torch" / "csrc"
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    stamped, designs = instrument(csrc, "old" if old else "new")
    # 14c's first version takes no O and leaves D to a PyTorch op
    d_inside = designs["flash_dq_kernel"] == "wgmma"
    dq_pointers = 5 if d_inside else 4  # dout, (o,) lse, delta, dq
    libs = {"stamped": build(stamped, dq_pointers)}
    plain = OUT / ("old_plain" if old else "new_plain")
    shutil.rmtree(plain, ignore_errors=True)
    shutil.copytree(csrc, plain)
    libs["plain"] = build(plain / "flash_attention.cu", dq_pointers)

    g = torch.Generator().manual_seed(0)
    dim = HEADS * DH
    qkv = torch.randn(N_SEQ, LENGTH, 3 * dim, generator=g).to("cuda", torch.bfloat16)
    dout = torch.randn(N_SEQ, LENGTH, dim, generator=g).to("cuda", torch.bfloat16)
    q, k, v = F._views(qkv, None)
    strides = F._strides(q, k)
    o = torch.empty(N_SEQ, LENGTH, dim, dtype=torch.bfloat16, device="cuda")
    lse = torch.empty(N_SEQ, HEADS, LENGTH, device="cuda")
    delta = torch.empty_like(lse)
    dq, dk, dv = F._views(torch.empty_like(qkv), None)
    stream = torch.cuda.current_stream().cuda_stream
    shape = (N_SEQ, LENGTH, LENGTH, HEADS, DH, stream)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, dout.data_ptr())

    def fwd(lib):
        return lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
                                    o.data_ptr(), lse.data_ptr(), *shape)

    def bwd_dq(lib):
        if not d_inside:
            return lib.flash_bwd_dq_launch(*head, lse.data_ptr(), delta.data_ptr(),
                                           dq.data_ptr(), *shape)
        return lib.flash_bwd_dq_launch(*head, o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                       dq.data_ptr(), *shape)

    def bwd_dkv(lib):
        return lib.flash_bwd_dkv_launch(*head, lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                        dv.data_ptr(), *shape)

    def ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    outs = {}
    for label, lib in libs.items():
        if fwd(lib):
            raise SystemExit("flash_fwd_launch failed")
        if not d_inside:
            delta.copy_(F.flash_delta(dout, o, HEADS))
        if bwd_dq(lib):
            raise SystemExit("flash_bwd_dq_launch failed")
        if bwd_dkv(lib):
            raise SystemExit("flash_bwd_dkv_launch failed")
        torch.cuda.synchronize()
        outs[label] = [t.clone() for t in (o, lse, dq, dk, dv)]
    same = all(torch.equal(a, b) for a, b in zip(outs["stamped"], outs["plain"]))
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    print(f"stamped outputs bitwise the plain build's: {same}")
    stamps = np.zeros((3, 132, 2, 9), np.int64)
    libs["stamped"].flash_stamps_read.argtypes = [ctypes.c_void_p]
    libs["stamped"].flash_stamps_read(stamps.ctypes.data)
    for idx, name, fn in ((0, "14a", fwd), (1, "14c", bwd_dq), (2, "14b", bwd_dkv)):
        kernel = KERNELS[idx]
        phases = PHASES[(kernel, designs[kernel])]
        tiles = stamps[idx, :, :, 8].sum()
        per = stamps[idx, :, :, :len(phases)].sum((0, 1)) / max(tiles, 1)
        times = {label: ms(lambda: fn(lib)) for label, lib in libs.items()}
        print(f"{name} {kernel} ({designs[kernel]}): {tiles} tiles stamped; cycles a tile: "
              + ", ".join(f"{p} {c:.0f}" for p, c in zip(phases, per))
              + f"; sum {per.sum():.0f}; ms {times['plain']:.4f} (stamped {times['stamped']:.4f})")


if __name__ == "__main__":
    main()
