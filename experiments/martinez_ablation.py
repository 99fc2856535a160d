"""Where does the Martinez block kernel (row 2, ``csrc/martinez.cu``) spend its time?

Builds variants of ``martinez.cu`` from a source directory (default:
``pose3d_tpu_torch/csrc``; ``--csrc DIR`` takes another tree's), and, with
``--old DIR``, that tree's ``martinez.cu`` beside them (the first version,
from an older commit unpacked under the gitignored ``logs/``). Each is a
text patch of a copy under ``logs/martinez_ablation/`` compiled alone with
``nvcc`` for ``sm_90a`` (its ptxas register, spill and "C75" lines are
printed), and each is timed on one block call (its two launches) at B in
``BATCHES`` on seeded operands: x ~ N(0, 1) bf16, W1, W2 ~ N(0, 1/1024)
bf16, scales in [0.5, 1.5), shifts in [-0.5, 0.5) f32.

Variants (where the source has the code they patch):

- shipped: the source as it is;
- n256 / n128 / n64: every batch on 128 x 256, 128 x 128 or 128 x 64
  output tiles (the launcher's ``n_tile`` patched);
- batch1 / batch8: the epilogue's loads issued 1 or 8 column groups at a
  time, not 4 (``kBatch``);
- refill0 / refill8 / refill12: the epilogue buffer refilled (the last
  stores waited for, the residual loaded) before a tile's K chunk 0, 8 or
  12, not its ``kRefillAt``-th;
- no_load: the producer arms each stage without loading it: the products
  (on whatever the stage holds) and the epilogue without the stream;
- no_epilogue: the epilogue's arithmetic taken out (scale, shift, ReLU,
  the residual add and the bf16 writes; its loads and stores stay);
- no_mma: the ``wgmma``s taken out (the TMA stream through the same tiles
  and ring, and the epilogue), at 128 x 256;
- stream: no ``wgmma`` and no epilogue arithmetic: the TMA stream alone at
  128 x 256. Its bytes from L2 (each tile's A boxes and W chunks, 16
  chunks a tile) over its time is the L2 -> SM rate of the stream.

Checks: the variants that compute the function (shipped, the N tiles, the
in-flight and pass choices, refill0, the first version) are held to the plain
PyTorch formula on the card at B in ``CHECKED``: rows within 5e-2 +
2^-5 |want| (``chip_smoke.py``'s limit). Times: ms a call, the median of 3
runs of 20 back-to-back calls fenced by CUDA events, after warm-up; the
host's time a call at B = 64 (the launcher alone through ctypes, 200
calls on the host clock without a synchronise: the first version encodes
no TMA map, the new one five). Prints the card's name and power limit
first.

Run on the card from the repository root:
``python3 experiments/martinez_ablation.py [--csrc DIR] [--old DIR] [--label NAME]
[--variants shipped,n128,...]``
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "logs" / "martinez_ablation"
HEADERS = ("common.cuh", "rowtile_sm90.cuh")
WIDTH = 1024
BATCHES = (64, 256, 1024, 2048, 4096, 8192)
CHECKED = (1, 129, 200, 8192, 10000)
TILE_FN = "int n_tile(int n_rows, int sms) {\n"
MMA_CALL = "        issue_chunk<kN>(acc, s + wg * rt::kBoxBytes, s + kABytes, kc > 0);\n"
EPILOGUE_START = "#pragma unroll\n      for (int jb = 0; jb < kN / 8; jb += kBatch) {\n"
EPILOGUE_END = "            rt::st_shared2(at(j, h), v0, v1);\n          }\n        }\n      }\n"
REFILL = "constexpr int kRefillAt = 4;"
CLAIM = "          const uint32_t dst = ring.claim(&bar);\n"
LOADS_END = "                         kc * rt::kBox);\n"
BAR = "          uint32_t bar;\n"
COMPLETE = ('          asm volatile("mbarrier.complete_tx.shared::cta.b64 [%0], %1;\\n" '
            ':: "r"(bar), "r"(T::kStageBytes) : "memory");\n')
BATCH1 = ("constexpr int kBatch = 4;", "constexpr int kBatch = 1;")
BATCH8 = ("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")


def _sub(s: str, old: str, new: str) -> str:
    if old not in s:
        raise SystemExit(f"the source has changed: no {old.strip()!r}")
    return s.replace(old, new)


def _cut(s: str, start: str, end: str) -> str:
    """s without the span from `start` to the end of the first `end` after it."""
    if start not in s:
        raise SystemExit(f"the source has changed: no {start.strip()!r}")
    i = s.index(start)
    return s[:i] + s[s.index(end, i) + len(end):]


def _tile(src: str, n: int) -> str:
    return _sub(src, TILE_FN, TILE_FN + f"  if (sms > 0) return {n};\n")


def variants(src: str) -> dict:
    """Each variant's name and a function that makes its source from src
    (SystemExit where src lacks the code it patches)."""
    out = {"shipped": lambda: src}
    if "issue_chunk<kN>" not in src:
        return out
    no_mma = lambda: _tile(_sub(src, MMA_CALL, "        (void)s;\n"), 256)

    def no_load():
        # the claim arms the stage for its bytes; a complete_tx of as many
        # bytes completes it without a load
        cut = _cut(src, CLAIM, LOADS_END)
        i = cut.index(BAR)
        body = BAR + "          ring.claim(&bar);\n" + COMPLETE
        return _tile(cut[:i] + body + cut[i + len(BAR):], 256)

    for n in (256, 128, 64):
        out[f"n{n}"] = lambda n=n: _tile(src, n)
    out.update({
        "batch1": lambda: _sub(src, *BATCH1),
        "batch8": lambda: _sub(src, *BATCH8),
        **{f"refill{k}": lambda k=k: _sub(src, REFILL, f"constexpr int kRefillAt = {k};")
           for k in (0, 8, 12)},
        "no_load": no_load,
        "no_epilogue": lambda: _tile(_cut(src, EPILOGUE_START, EPILOGUE_END), 256),
        "no_mma": no_mma,
        "stream": lambda: _cut(no_mma(), EPILOGUE_START, EPILOGUE_END),
    })
    return out


def build_all(nvcc: str, dirs: list[Path]) -> list[ctypes.CDLL | None]:
    """Compiles each directory's martinez.cu alone, all at once; prints
    each gemm kernel's ptxas lines and any "C75" warning; None for a
    variant that does not build."""
    procs = []
    for d in dirs:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(d), "-o",
               str(d / "lib.so"), str(d / "martinez.cu")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    libs = []
    for d, proc in zip(dirs, procs):
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:  # a variant that does not build is reported and left out
            print(f"  {d.name}: nvcc failed:\n{log[-2000:]}")
            libs.append(None)
            continue
        lines = log.splitlines()
        for k, line in enumerate(lines):
            if "Compiling entry" in line and "gemm" in line:
                print(f"  {d.name}: {' '.join(x.strip() for x in lines[k:k + 4])[:320]}")
            elif "C75" in line:
                print(f"  {d.name}: {line.strip()[:300]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.martinez_launch.argtypes = [p] * 9 + [i, i, p]
        lib.martinez_launch.restype = i
        libs.append(lib)
    return libs


def timed(fn, n=20) -> float:
    import torch

    for _ in range(3):
        fn()
    runs = []
    for _ in range(3):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize()
        runs.append(t0.elapsed_time(t1) / n)
    return statistics.median(runs)


def stream_bytes(batch: int, n: int) -> int:
    """Bytes a call's two GEMMs read from L2 into the ring at N tile n:
    per 128 x n tile, 16 chunks of both A boxes (16 KB) and the W chunk
    (n / 64 boxes of 8 KB)."""
    tiles = -(-batch // 128) * (WIDTH // n)
    return 2 * tiles * 16 * (16384 + (n // 64) * 8192)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=Path, default=REPO / "pose3d_tpu_torch" / "csrc")
    ap.add_argument("--old", type=Path, default=None,
                    help="a csrc directory whose martinez.cu is timed as first_version")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--variants", default="",
                    help="comma-separated variant names to run (default: all)")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from pose3d_tpu_torch.ops import _build
    from pose3d_tpu_torch.ops.martinez import fused_residual_block_reference

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    tag = f"{args.label} martinez"
    print(f"{tag}: {smi.stdout.strip()}", flush=True)
    nvcc = _build._nvcc()
    root = OUT / args.label
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator("cuda").manual_seed(0)
    f = WIDTH
    w1, w2 = ((torch.randn(f, f, device="cuda", generator=gen) / 32).to(torch.bfloat16)
              for _ in range(2))
    s1, s2 = (0.5 + torch.rand(f, device="cuda", generator=gen) for _ in range(2))
    b1, b2 = (torch.rand(f, device="cuda", generator=gen) - 0.5 for _ in range(2))
    top = max(BATCHES + CHECKED)
    x_all = torch.randn(top, f, device="cuda", generator=gen).to(torch.bfloat16)
    h = torch.empty_like(x_all)
    out = torch.empty_like(x_all)
    stream = torch.cuda.current_stream().cuda_stream
    wants = {b: fused_residual_block_reference(x_all[:b], w1, s1, b1, w2, s2, b2)
             for b in CHECKED}
    t8192 = {}

    makers = variants((args.csrc / "martinez.cu").read_text())
    if args.old is not None:
        old_src = (args.old / "martinez.cu").read_text()
        makers["first_version"] = lambda: old_src
    if args.variants:
        keep = args.variants.split(",")
        makers = {k: v for k, v in makers.items() if k in keep}
    sources = {}
    for name, make in makers.items():
        try:
            sources[name] = make()
        except SystemExit as e:  # a source without the code the variant patches
            print(f"{tag} {name}: left out ({e})")
    dirs = []
    for name, text in sources.items():
        vd = root / name
        vd.mkdir(parents=True)
        hdr_dir = args.old if name == "first_version" else args.csrc
        for hdr in HEADERS:
            if (hdr_dir / hdr).exists():
                shutil.copy(hdr_dir / hdr, vd / hdr)
        (vd / "martinez.cu").write_text(text)
        dirs.append(vd)
    for name, lib in zip(sources, build_all(nvcc, dirs)):
        if lib is None:
            if name == "shipped":
                raise SystemExit("the shipped source does not build")
            continue

        def call(batch, lib=lib, name=name):
            err = lib.martinez_launch(x_all.data_ptr(), w1.data_ptr(), s1.data_ptr(),
                                      b1.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(),
                                      h.data_ptr(), out.data_ptr(), batch, WIDTH, stream)
            if err:
                raise SystemExit(f"{name}: CUDA error {err}")

        if not name.startswith(("no_mma", "no_load", "no_epilogue", "stream")):
            for batch in CHECKED:
                call(batch)
                torch.cuda.synchronize()
                got, want = out[:batch].float(), wants[batch].float()
                excess = ((got - want).abs() - (5e-2 + 2 ** -5 * want.abs())).max().item()
                if not (torch.isfinite(got).all() and excess <= 0):
                    raise SystemExit(f"{name} B={batch}: disagrees with the plain formula "
                                     f"(worst excess {excess:.4g})")
            print(f"{tag} {name}: within 5e-2 + 2^-5|want| of the plain formula at B in "
                  f"{CHECKED}", flush=True)
        times = {b: timed(lambda b=b: call(b)) for b in BATCHES}
        t8192[name] = times[8192]
        line = ", ".join(f"B={b} {ms:.4f}" for b, ms in times.items())
        print(f"{tag} {name} ms: {line}", flush=True)
        if name.startswith("stream"):
            nbytes = stream_bytes(8192, 256)
            print(f"{tag} {name}: {nbytes / 1e6:.1f} MB from L2 a call at B=8192, "
                  f"{nbytes / times[8192] / 1e9:.3f} TB/s (L2 -> SM)", flush=True)
        if name in ("shipped", "first_version"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call(64)
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            print(f"{tag} {name}: host time a call at B=64 (launcher alone): {host_us:.2f} us",
                  flush=True)
    flops = 4 * 8192 * f * f
    for name, ms in t8192.items():
        print(f"{tag} {name} at B=8192: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s "
              f"({flops / ms / 1e9 / 989:.1%} of 989)")


if __name__ == "__main__":
    main()
