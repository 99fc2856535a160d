"""Where does a tile of flash attention's query-major kernels (14a, 14c) spend its time?

Copies ``pose3d_tpu_torch/csrc`` (or, with ``--old DIR``, ``DIR/pose3d_tpu_torch/csrc``
of another tree, e.g. a ``git archive`` of an older commit unpacked under the
gitignored ``logs/``) to ``logs/flash_stamps/<name>/``, adds clock64 stamps to the
copy's ``flash_attention.cu`` after each phase of a K/V tile in ``flash_fwd_kernel``
(14a) and ``flash_dq_kernel`` (14c), taken by the first thread of each consumer
warpgroup (of each 128 threads in a first version's block) in the first 132 CTAs,
builds that file alone into a library (nvcc, the port's flags), and runs both
kernels on seeded bf16 rows at the long-clip shape, 34 sequences x 2048 frames x 8
heads x 32, printing the mean cycles a tile of each phase and the kernels' ms with
and without the stamps. A stamp orders nothing: where a product's result is read
only in a later phase, that phase takes its wait.

Phases of the redesign (wgmma fed by a TMA ring; tiles 2..n of a work tile):
14a: ring wait, S product (with the last tile's P V issued), softmax, P V tail,
rescale + convert. 14c: S wait (the last tile's dS K and this S), exponentials, dP
wait, dS + convert, then dS K, the ring wait and the next S and dP issued as one
phase (stamps between those issues made ptxas serialise them: 14c ran at 0.97 ms
stamped against 0.56). Phases of the first versions
(mma.sync on cp.async tiles): 14a: wait (cp.async + barrier), S product, softmax,
P V (+ barrier); 14c: wait, S and dP products, exponentials + dS, dS K (+ barrier).

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

STAMPS = '''
__device__ long long g_flash_stamps[2][132][2][9];  // kernel, CTA, warpgroup, phases + tiles
extern "C" int flash_stamps_read(void* out) {
  return cudaMemcpyFromSymbol(out, g_flash_stamps, sizeof(g_flash_stamps));
}
#define FS_DECL long long fs_ph[8] = {0, 0, 0, 0, 0, 0, 0, 0}, fs_t = 0, fs_n = 0; \\
  const bool fs_on = threadIdx.x % 128 == 0 && blockIdx.x < 132;
#define FS_START do { if (fs_on) fs_t = clock64(); } while (0)
#define FS(k) do { if (fs_on) { const long long c_ = clock64(); fs_ph[k] += c_ - fs_t; \\
  fs_t = c_; } } while (0)
#define FS_TILE do { if (fs_on) ++fs_n; } while (0)
#define FS_SAVE(K) do { if (fs_on) { for (int i_ = 0; i_ < 8; ++i_) \\
  g_flash_stamps[K][blockIdx.x][threadIdx.x / 128 % 2][i_] = fs_ph[i_]; \\
  g_flash_stamps[K][blockIdx.x][threadIdx.x / 128 % 2][8] = fs_n; } } while (0)
'''

# (anchor, after: True inserts after the anchor's line, False before it, text); each
# anchor is searched from the previous one's line on.
NEW = {
    "flash_fwd_kernel": (
        ("rt::regs_inc<", True, "  FS_DECL"),
        ("for (int kt = 1; kt < n_kt; ++kt) {", True, "      FS_START;"),
        ("const uint32_t next = ring.acquire();", True, "      FS(0);"),
        ("rt::wgmma_wait<1>();", True, "      FS(1);"),
        ("online_softmax<kN>(s, sl, Lk - kt * kN", True, "      FS(2);"),
        ("rt::wgmma_wait<0>();", True, "      FS(3);"),
        ("kv = next;", True, "      FS(4); FS_TILE;"),
        ("slots.release(slots.next - 1);", True, "    FS_SAVE(0);"),
    ),
    "flash_dq_kernel": (
        ("rt::regs_inc<", True, "  FS_DECL"),
        ("auto step = [&]", True, "      FS_START;"),
        ("rt::wgmma_wait<1>();", True, "      FS(0);"),
        ("= ex2(fmaf(", True, "      FS(1);"),
        ("rt::wgmma_wait<0>();", True, "      FS(2);"),
        ("to_frags<kN>(s, ds);", True, "      FS(3);"),
        ("    };", False, "      FS(4); FS_TILE;"),
        ("slots.release(slots.next - 1);", True, "    FS_SAVE(1);"),
    ),
}
OLD = {
    "flash_fwd_kernel": (
        ("const unsigned ro = rows_offset<DH>(lane)", True, "  FS_DECL"),
        ("for (int kt = 0; kt < n_kt; ++kt) {", True, "    FS_START;"),
        ("__syncthreads();", True, "    FS(0);"),
        ("tile_scores<DH>(qa,", True, "    FS(1);"),
        ("tile_accumulate<DH>(s,", False, "    FS(2);"),
        ("__syncthreads();", True, "    FS(3); FS_TILE;"),
        ("l0 = quad_sum(l0);", False, "  FS_SAVE(0);"),
    ),
    "flash_dq_kernel": (
        ("const unsigned ro = rows_offset<DH>(lane)", True, "  FS_DECL"),
        ("for (int kt = 0; kt < n_kt; ++kt) {", True, "    FS_START;"),
        ("__syncthreads();", True, "    FS(0);"),
        ("tile_scores<DH>(da,", True, "    FS(1);"),
        ("tile_accumulate<DH>(s,", False, "    FS(2);"),
        ("__syncthreads();", True, "    FS(3); FS_TILE;"),
        ("constexpr float sc = head_scale<DH>();", False, "  FS_SAVE(1);"),
    ),
}
PHASES = {
    ("new", 0): ("ring wait", "S product", "softmax", "P V tail", "rescale + convert"),
    ("new", 1): ("S wait", "exponentials", "dP wait", "dS + convert",
                 "dS K, ring wait, S and dP issued"),
    ("old", 0): ("wait", "S product", "softmax", "P V"),
    ("old", 1): ("wait", "S, dP products", "exponentials + dS", "dS K"),
}


def instrument(csrc: Path, name: str, old: bool) -> Path:
    """The instrumented copy of csrc's flash_attention.cu; returns its path."""
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    src = dst / "flash_attention.cu"
    lines = src.read_text().split("\n")
    inserts = []
    for kernel, anchors in (OLD if old else NEW).items():
        i = next(n for n, line in enumerate(lines) if line.startswith(kernel + "("))
        for anchor, after, text in anchors:
            i = next((n for n in range(i, len(lines)) if anchor in lines[n]), None)
            if i is None:
                raise SystemExit(f"{src.name} has changed: no {anchor!r} in {kernel}")
            if text:
                inserts.append((i + 1 if after else i, text))
    for i, text in sorted(inserts, reverse=True):
        lines.insert(i, text)
    s = "\n".join(lines)
    anchor = "namespace {\n"
    if s.count(anchor) != 1:
        raise SystemExit("flash_attention.cu has changed: no anonymous namespace to precede")
    src.write_text(s.replace(anchor, STAMPS + anchor))
    return src


def build(src: Path) -> ctypes.CDLL:
    sys.path.insert(0, str(REPO))
    from pose3d_tpu_torch.ops import _build

    so = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-shared", "-o",
                    str(so), str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_fwd_launch.argtypes = [p] * 3 + [ll] * 4 + [p, p] + [i] * 5 + [p]
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
    libs = {"stamped": build(instrument(csrc, "old" if old else "new", old))}
    plain = OUT / ("old_plain" if old else "new_plain")
    shutil.rmtree(plain, ignore_errors=True)
    shutil.copytree(csrc, plain)
    libs["plain"] = build(plain / "flash_attention.cu")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in libs.values():
        pointers = 4 if old else 5  # dout, (o,) lse, delta, dq
        lib.flash_bwd_dq_launch.argtypes = [p] * 3 + [ll] * 4 + [p] * pointers + [i] * 5 + [p]

    g = torch.Generator().manual_seed(0)
    dim = HEADS * DH
    qkv = torch.randn(N_SEQ, LENGTH, 3 * dim, generator=g).to("cuda", torch.bfloat16)
    dout = torch.randn(N_SEQ, LENGTH, dim, generator=g).to("cuda", torch.bfloat16)
    q, k, v = F._views(qkv, None)
    strides = F._strides(q, k)
    o = torch.empty(N_SEQ, LENGTH, dim, dtype=torch.bfloat16, device="cuda")
    lse = torch.empty(N_SEQ, HEADS, LENGTH, device="cuda")
    delta = torch.empty_like(lse)
    dq = F._views(torch.empty_like(qkv), None)[0]
    stream = torch.cuda.current_stream().cuda_stream
    shape = (N_SEQ, LENGTH, LENGTH, HEADS, DH, stream)

    def fwd(lib):
        return lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
                                    o.data_ptr(), lse.data_ptr(), *shape)

    def bwd_dq(lib):
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, dout.data_ptr())
        if old:
            return lib.flash_bwd_dq_launch(*head, lse.data_ptr(), delta.data_ptr(),
                                           dq.data_ptr(), *shape)
        return lib.flash_bwd_dq_launch(*head, o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                       dq.data_ptr(), *shape)

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

    for lib in libs.values():
        if fwd(lib):
            raise SystemExit("flash_fwd_launch failed")
        if old:
            delta.copy_(F.flash_delta(dout, o, HEADS))
        if bwd_dq(lib):
            raise SystemExit("flash_bwd_dq_launch failed")
    torch.cuda.synchronize()
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    tree = "first versions (mma.sync)" if old else "redesign (wgmma, TMA ring)"
    stamps = np.zeros((2, 132, 2, 9), np.int64)
    libs["stamped"].flash_stamps_read.argtypes = [p]
    libs["stamped"].flash_stamps_read(stamps.ctypes.data)
    for kernel, name, fn in ((0, "14a flash_fwd_kernel", fwd), (1, "14c flash_dq_kernel", bwd_dq)):
        phases = PHASES[("old" if old else "new", kernel)]
        tiles = stamps[kernel, :, :, 8].sum()
        per = stamps[kernel, :, :, :len(phases)].sum((0, 1)) / max(tiles, 1)
        times = {label: ms(lambda: fn(lib)) for label, lib in libs.items()}
        print(f"{tree} {name}: {tiles} tiles stamped; cycles a tile: "
              + ", ".join(f"{p} {c:.0f}" for p, c in zip(phases, per))
              + f"; sum {per.sum():.0f}; ms {times['plain']:.4f} (stamped {times['stamped']:.4f})")


if __name__ == "__main__":
    main()
