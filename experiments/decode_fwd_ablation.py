"""Where do the direct decode forwards (kernels 11a and 13a) spend their time?

Builds variants of a kernel's source from a source directory (default:
``pose3d_tpu_torch/csrc``; ``--csrc DIR`` takes another tree's, such as an
older commit unpacked under the gitignored ``logs/``), each a text patch
of a copy under ``logs/decode_ablation/`` compiled alone with ``nvcc`` for
``sm_90a``, and times each variant's forward (both of its launches) at
the direct model's shape, B = 64 on 64 x 64 head outputs, J = 17, D = 64:

- ``--kernel softargmax`` (11a, ``softargmax.cu``): bf16 logits (B, 64,
  64, 17 x 64), seeded N(0, 1), 570 MB; beside the variants, a plain read
  of the same bytes (16 bytes a thread, a grid-stride loop, one XOR a
  vector): the HBM rate this card reaches on a read alone; and the same
  bytes by bulk copies alone (one thread a CTA keeping a ring of copies in
  flight, at several chunk sizes and depths);
- ``--kernel conv_decode`` (13a, ``conv_decode.cu``): bf16 features (B,
  64, 64, 256) ~ N(0, 1), weight (17 x 64, 256) ~ N(0, 1/16), f32 bias ~
  N(0, 0.01); beside the variants, the 1x1 conv alone as one bf16
  ``torch.matmul``.

Variants (where the source has the code they patch):

- shipped: the source as it is (checked against the plain PyTorch
  formula, within 1e-3);
- softargmax, the first version (a CTA per (sample, tile)): no_math (each
  vector's online-softmax update replaced by a plain sum of its values:
  what the loads alone cost), no_fold (the tile's fold of each joint's
  partials cut to one load), ex2 (exp2f replaced by ex2.approx.ftz);
- softargmax, the streaming version (each thread's own ring of cp.async
  copies): no_math as above, no_exp (the exponent without its exp2),
  double_math (a second exp2 and sum of every logit), depth4 / depth12
  (4 or 12 copies in flight a thread, not 8), threads256 / threads512
  (blocks of up to 256 or 512 threads, not 1024), no_fold (each joint's
  tile partial from one thread's);
- conv_decode, the wgmma version: no_epilogue (each joint's softmax
  partial replaced by two register moves: the products and the slab
  stream alone), stages3 / stages4 (a 3- or 4-stage slab ring, not 5).

Times: ms a call, the median of 3 runs of 20 back-to-back calls fenced by
CUDA events, after warm-up; the variants other than ``shipped`` may
compute wrong values and are timing variants only. Prints the card's
name and power limit first; with ``--clocks``, also the SM clock and the
power draw that nvidia-smi reads while each variant runs for ~2 s.

Run on the card from the repository root:
``python3 experiments/decode_fwd_ablation.py --kernel softargmax|conv_decode
[--csrc DIR] [--label NAME] [--clocks]``
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "logs" / "decode_ablation"
HEADERS = ("common.cuh", "softargmax.cuh", "rowtile_sm90.cuh", "conv_decode.cuh")
EX2 = ('__device__ __forceinline__ float ex2_fast(float x) {\n  float y;\n'
       '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n  return y;\n}\n\n')
READ_KERNEL = r'''
#include <cuda_runtime.h>
#include <cstdint>
__global__ void read_kernel(const uint4* __restrict__ p, long long n, unsigned* out) {
  unsigned acc = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint4 u = __ldcs(p + i);
    acc ^= u.x ^ u.y ^ u.z ^ u.w;
  }
  if (acc == 0x9e3779b9u) out[0] = acc;  // keeps the loads
}
extern "C" int read_launch(const void* p, long long bytes, void* out, int blocks, void* s) {
  read_kernel<<<blocks, 512, 0, static_cast<cudaStream_t>(s)>>>(
      static_cast<const uint4*>(p), bytes / 16, static_cast<unsigned*>(out));
  return cudaGetLastError();
}

// The same bytes by bulk copies alone: one thread a CTA keeps `stages`
// copies of `chunk` bytes in flight into shared memory, waiting only for
// a stage's copy to land before it reuses the stage; CTA k takes chunks k,
// k + grid, ... (interleave) or a contiguous run of them.
__device__ __forceinline__ void bulk_wait(unsigned bar, unsigned parity) {
  asm volatile("{\n.reg .pred p;\nW: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               "@!p bra W;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}
__global__ void bulk_read_kernel(const unsigned char* p, long long n_chunks, int chunk,
                                 int interleave, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned bars = base + stages * chunk;
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bars + 8 * s) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const long long per = (n_chunks + gridDim.x - 1) / gridDim.x;
  const long long count = interleave ? (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x
                                     : max(0LL, min(per, n_chunks - blockIdx.x * per));
  for (long long i = 0; i < count + stages; ++i) {
    if (i >= stages)
      bulk_wait(bars + 8 * ((i - stages) % stages), ((i - stages) / stages) & 1);
    if (i < count) {
      const unsigned s = i % stages, bar = bars + 8 * s;
      const long long id = interleave ? blockIdx.x + i * gridDim.x : blockIdx.x * per + i;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar), "r"(chunk) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                   "[%0], [%1], %2, [%3];\n" :: "r"(base + s * chunk), "l"(p + id * chunk),
                   "r"(chunk), "r"(bar) : "memory");
    }
  }
}
extern "C" int bulk_read_launch(const void* p, long long bytes, int chunk, int interleave,
                                int stages, int blocks, void* s) {
  const int smem = stages * chunk + 8 * stages;
  cudaFuncSetAttribute(bulk_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  bulk_read_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(s)>>>(
      static_cast<const unsigned char*>(p), bytes / chunk, chunk, interleave, stages);
  return cudaGetLastError();
}
'''


def _replace_span(s: str, start: str, end: str, new: str) -> str:
    """s with the span from `start` to the end of the first `end` after it
    replaced by `new`."""
    i = s.index(start)
    j = s.index(end, i) + len(end)
    return s[:i] + new + s[j:]


def _sub(s: str, old: str, new: str) -> str:
    if old not in s:
        raise SystemExit(f"the source has changed: no {old.strip()!r}")
    return s.replace(old, new)


def softargmax_variants(src: str) -> dict[str, str]:
    out = {"shipped": src}
    if "void __launch_bounds__(1024) tile_kernel(" in src:  # the first version
        out["no_math"] = _replace_span(
            src, "      float mx = f[u][0];", "      acc.sz += fmaf(ps, d0, pz);\n",
            "      float t = 0.f;\n#pragma unroll\n      for (int i = 0; i < V; ++i) "
            "t += f[u][i];\n      acc.s += t;\n")
        out["no_fold"] = _replace_span(
            src, "    for (int rr = 0; rr < rows; ++rr)\n",
            "        t.merge(Partial::load_strided(red + rr * n_vec + vv, stride));\n",
            "    t = Partial::load_strided(red + j * per_joint, stride);\n")
        out["ex2"] = _sub(src.replace("exp2f(", "ex2_fast("), "namespace {\n",
                          "namespace {\n" + EX2)
    if "struct Cursor" in src:  # the streaming version: a cp.async ring a thread
        out["no_math"] = _replace_span(
            src, "      float mx = f[0];", "      acc.sz += fmaf(ps, d0, pz);\n",
            "      float q = 0.f;\n#pragma unroll\n      for (int e = 0; e < V; ++e) q += f[e];\n"
            "      acc.s += q;\n")
        out["no_exp"] = _sub(
            src, "const float p = ex2((f[e] - acc.m) * kLog2e);",
            "const float p = (f[e] - acc.m) * kLog2e;")
        out["double_math"] = _sub(
            src, "      acc.sz += fmaf(ps, d0, pz);\n",
            "      acc.sz += fmaf(ps, d0, pz);\n#pragma unroll\n      for (int e = 0; e < V; "
            "++e) acc.sx += ex2((f[e] - acc.m) * kLog2e);\n")
        for n in (4, 12):
            out[f"depth{n}"] = _sub(src, "constexpr int kFwdDepth = 8;",
                                    f"constexpr int kFwdDepth = {n};")
        for n in (256, 512):
            out[f"threads{n}"] = _sub(src, "constexpr int kFwdThreads = 1024;",
                                      f"constexpr int kFwdThreads = {n};")
        out["no_fold"] = _replace_span(
            src, "      for (int q = lane; q < count; q += 32)\n", "threads));\n",
            "      if (lane < count) p = Partial::load_strided(red + j * per_joint, threads);\n")
    return out


def conv_decode_variants(src: str) -> dict[str, str]:
    out = {"shipped": src}
    if "issue_logits(" in src:  # the wgmma version
        out["no_epilogue"] = _sub(
            src, "      const Partial pt = joint_partial(acc, bv, rows, q);",
            "      Partial pt;\n      pt.m = acc[0] + bv[0].x;\n      pt.s = acc[31];")
        for n in (3, 4):
            out[f"stages{n}"] = _sub(src, "constexpr int kStages = 5;",
                                     f"constexpr int kStages = {n};")
    return out


def build(nvcc: str, d: Path, source: str, kernel: str = "") -> ctypes.CDLL:
    so = d / "lib.so"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(d), "-o", str(so), str(d / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {d}:\n{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for k, line in enumerate(lines):  # the kernel's registers, spills and warnings
        if kernel and kernel in line and ("Function properties" in line or "C75" in line):
            print(f"  {d.name}: {' '.join(x.strip() for x in lines[k:k + 3])[:300]}")
    return ctypes.CDLL(str(so))


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


def clocks_under(fn, seconds: float = 2.0) -> str:
    """The SM clock and the power draw (medians of nvidia-smi's 50 ms
    samples) while fn runs back to back for about `seconds`."""
    import torch

    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    n = max(1, int(seconds * 1e3 / max(t0.elapsed_time(t1), 1e-3)))
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        lines = smi.communicate()[0].splitlines()
    samples = [tuple(float(v) for v in line.split(",")) for line in lines if "," in line]
    samples = samples[len(samples) // 4:]  # after the clock settles
    if not samples:
        return "no nvidia-smi samples"
    return (f"SM clock {statistics.median(c for c, _ in samples):.0f} MHz, power "
            f"{statistics.median(w for _, w in samples):.0f} W ({len(samples)} samples)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("softargmax", "conv_decode"), required=True)
    ap.add_argument("--csrc", type=Path, default=REPO / "pose3d_tpu_torch" / "csrc")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--clocks", action="store_true",
                    help="also sample the SM clock and power while each variant runs")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from pose3d_tpu_torch.ops import _build
    from pose3d_tpu_torch.ops.conv_decode import conv_soft_argmax_3d_expectations_reference
    from pose3d_tpu_torch.ops.heatmap import nhwc_expectations

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    tag = f"{args.label} {args.kernel}"
    print(f"{tag}: {smi.stdout.strip()}")
    nvcc = _build._nvcc()
    root = OUT / args.label / args.kernel
    shutil.rmtree(root, ignore_errors=True)
    b, h, w, j, d = 64, 64, 64, 17, 64
    gen = torch.Generator("cuda").manual_seed(0)
    part = torch.empty(b * j, -(-(h * w) // 128), 5, device="cuda")
    out = torch.empty(b, j, 3, device="cuda")
    stats = torch.empty(b, j, 2, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int

    if args.kernel == "softargmax":
        x = torch.randn(b, h, w, j * d, device="cuda", generator=gen).to(torch.bfloat16)
        nbytes = x.numel() * x.element_size()
        rd = root / "read"
        rd.mkdir(parents=True)
        (rd / "read.cu").write_text(READ_KERNEL)
        lib = build(nvcc, rd, "read.cu")
        lib.read_launch.argtypes = [p, ctypes.c_longlong, p, i, p]
        sink = torch.zeros(1, device="cuda", dtype=torch.int32)
        blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
        def read():
            lib.read_launch(x.data_ptr(), nbytes, sink.data_ptr(), blocks, stream)

        ms = timed(read)
        print(f"{tag} plain read of {nbytes / 1e6:.1f} MB: {ms:.4f} ms, "
              f"{nbytes / ms / 1e6:.1f} GB/s ({nbytes / ms / 1e6 / 3350:.1%} of 3.35 TB/s)"
              + (f"; {clocks_under(read)}" if args.clocks else ""))
        lib.bulk_read_launch.argtypes = [p, ctypes.c_longlong, i, i, i, i, p]
        sms = blocks // 4
        for chunk, stages, interleave, ctas in ((32768, 6, 0, 1), (32768, 6, 1, 1),
                                                (16384, 12, 0, 1), (8192, 24, 0, 1),
                                                (32768, 3, 0, 2), (4096, 48, 0, 1)):
            ms = timed(lambda: lib.bulk_read_launch(x.data_ptr(), nbytes, chunk, interleave,
                                                    stages, ctas * sms, stream))
            print(f"{tag} bulk-copy read, {chunk} B x {stages} stages, {ctas} CTA an SM, "
                  f"{'interleaved' if interleave else 'contiguous'}: {ms:.4f} ms, "
                  f"{nbytes / ms / 1e6:.1f} GB/s")
        source, variants, symbol = "softargmax.cu", softargmax_variants, "13__nv_bfloat16"
        want = nhwc_expectations(x, j, d)
        argtypes = [p, i, p, p, p] + [i] * 6 + [p]
        launch_args = (x.data_ptr(), 1, part.data_ptr(), out.data_ptr(), stats.data_ptr(), b, h,
                       w, j, d, 128, stream)
        entry = "softargmax_nhwc_launch"
    else:
        feats = torch.randn(b, h, w, 256, device="cuda", generator=gen).to(torch.bfloat16)
        weight = (torch.randn(j * d, 256, device="cuda", generator=gen) / 4).to(torch.bfloat16)
        bias = torch.randn(j * d, device="cuda", generator=gen) * 0.1
        rows = feats.view(-1, 256)
        ms = timed(lambda: rows @ weight.t())
        print(f"{tag} the 1x1 conv alone, torch.matmul: {ms:.4f} ms")
        source, variants, symbol = "conv_decode.cu", conv_decode_variants, "decode_kernel"
        want = conv_soft_argmax_3d_expectations_reference(feats, weight, bias, j, d)
        argtypes = [p] * 6 + [i] * 7 + [p]
        launch_args = (feats.data_ptr(), weight.data_ptr(), bias.data_ptr(), part.data_ptr(),
                       out.data_ptr(), stats.data_ptr(), b, h, w, 256, j, d, 128, stream)
        entry = "conv_decode_launch"

    ref = None
    for name, text in variants((args.csrc / source).read_text()).items():
        vd = root / name
        vd.mkdir(parents=True)
        for hdr in HEADERS:
            if (args.csrc / hdr).exists():
                shutil.copy(args.csrc / hdr, vd / hdr)
        (vd / source).write_text(text)
        fn = getattr(build(nvcc, vd, source, symbol), entry)
        fn.argtypes = argtypes
        fn.restype = i

        def call():
            err = fn(*launch_args)
            if err:
                raise SystemExit(f"{name}: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        got = out.clone()
        if name == "shipped":
            ref = got
            err = (got - want).abs().max().item()
            print(f"{tag} shipped vs the plain PyTorch formula: max abs err {err:.3g}")
            if not err < 1e-3:
                raise SystemExit("the shipped variant is wrong")
        ms = timed(call)
        rate = (f", {nbytes / ms / 1e6:.1f} GB/s ({nbytes / ms / 1e6 / 3350:.1%} of 3.35 TB/s)"
                if args.kernel == "softargmax" else "")
        print(f"{tag} {name}: {ms:.4f} ms{rate}; max |out - shipped| "
              f"{(got - ref).abs().max().item():.3g}"
              + (f"; {clocks_under(call)}" if args.clocks else ""))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
