"""Variants of flash attention's dK/dV kernel (14b, ``flash_dkv_kernel`` in
``csrc/flash_attention.cu``) beside the shipped one.

Each variant is a text patch of a copy of ``pose3d_tpu_torch/csrc`` under
``logs/flash_dkv_ablation/<name>/``; ``a+b`` applies both patches. Every copy's
``flash_attention.cu`` is compiled alone with ``nvcc`` for ``sm_90a`` (all at
once), its ptxas lines for ``flash_dkv_kernel`` at dh 16, 32 and 64 printed
(registers, spills, and "C7512 ... serialized"), and its 14b run after the
shipped 14a and 14c on seeded bf16 rows at the long-clip shape, 34 sequences x
2048 frames x 8 heads x 32 (``--dh 16`` or ``64``: 16 or 4 heads; qkv and dO ~
N(0, 1)): dK and dV against the shipped
build's (bitwise, or the max abs difference where a variant sums in another
order), and ms a call, the median of 3 runs of 20 back-to-back calls fenced by
CUDA events, the variants taken in turn (shipped first and last).

Variants (where the source has the code they patch):

- shipped: the source as it is;
- retire: a tile's dV and dK products retired before the next tile's S^T
  and dP^T go out (no register products in flight beside those);
- s_beside: only the next S^T beside dV and dK, dP^T issued once they
  retire;
- ds_in_dp: dS formed in dP's registers, not S's;
- merged: dK and dV one accumulator array, S^T and dP^T another;
- q32 / q64: 32- or 64-query stages at every head width;
- loads: the producer lanes bring lse and D by plain loads and stores and
  an arrival, not by cp.async;
- skew: the second consumer warpgroup starts ~600 cycles late, so that the
  warpgroups' exponentials need not fall together;
- stages8: 8 stages in the Q/dO ring, not 4;
- together: dV's product issued with dK's, after dS is formed, not before.

Run on the card from the repository root:
``python3 experiments/flash_dkv_ablation.py [--variants shipped,q32,...]``
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
OUT = REPO / "logs" / "flash_dkv_ablation"
N_SEQ, LENGTH, DIM = 34, 2048, 256

DS_OLD = '''        s[4 * j] *= dp[4 * j] - d.x;
        s[4 * j + 1] *= dp[4 * j + 1] - d.y;
        s[4 * j + 2] *= dp[4 * j + 2] - d.x;
        s[4 * j + 3] *= dp[4 * j + 3] - d.y;
      }
      to_frags<kN>(s, ds);
'''
DS_NEW = '''        dp[4 * j] = s[4 * j] * (dp[4 * j] - d.x);
        dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d.y);
        dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d.x);
        dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d.y);
      }
      to_frags<kN>(dp, ds);
'''
DV_EARLY = ("      rt::wgmma_fence();\n"
            "      issue_rows<DH, kN>(dva, p, qd + T::kTileBytes);"
            "  // dV += P^T dO, under dS's forming\n"
            "      rt::wgmma_commit();\n")
DV_CALL = "      issue_rows<DH, kN>(dva, p, qd + T::kTileBytes);\n"
DK_CALL = "      issue_rows<DH, kN>(dka, ds, qd);  // dK += dS^T Q\n"
QUERIES = "  static constexpr int kQueries = "
ARRAYS = "    float dka[DH / 2], dva[DH / 2], s[kN / 2], dp[kN / 2];\n"
MERGED = ("    float dkv[DH], sdp[kN];\n"
          "    auto& dka = *reinterpret_cast<float(*)[DH / 2]>(dkv);\n"
          "    auto& dva = *reinterpret_cast<float(*)[DH / 2]>(dkv + DH / 2);\n"
          "    auto& s = *reinterpret_cast<float(*)[kN / 2]>(sdp);\n"
          "    auto& dp = *reinterpret_cast<float(*)[kN / 2]>(sdp + kN / 2);\n")
TAIL = '''      rt::wgmma_commit();
      if constexpr (decltype(more)::value) {
        qd = ring.acquire();
        st = slice();
        issue_scores<DH, kN>(s, k_a, qd);
        rt::wgmma_commit();
        issue_scores<DH, kN>(dp, v_a, qd + T::kTileBytes);
        rt::wgmma_commit();
        rt::wgmma_wait<2>();  // dV and dK have retired: their Q and dO stage is free
        rt::fence_acc(dka);
        rt::fence_acc(dva);
        ring.release(ring.next - 2);
      } else {
'''
RETIRE = '''      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_acc(dka);
      rt::fence_acc(dva);
      ring.release(ring.next - 1);
      if constexpr (decltype(more)::value) {
        qd = ring.acquire();
        st = slice();
        issue_scores<DH, kN>(s, k_a, qd);
        rt::wgmma_commit();
        issue_scores<DH, kN>(dp, v_a, qd + T::kTileBytes);
        rt::wgmma_commit();
      } else if constexpr (false) {
'''
S_BESIDE = '''      rt::wgmma_commit();
      if constexpr (decltype(more)::value) {
        qd = ring.acquire();
        st = slice();
        issue_scores<DH, kN>(s, k_a, qd);
        rt::wgmma_commit();
        rt::wgmma_wait<1>();
        rt::fence_acc(dka);
        rt::fence_acc(dva);
        ring.release(ring.next - 2);
        issue_scores<DH, kN>(dp, v_a, qd + T::kTileBytes);
        rt::wgmma_commit();
      } else {
'''
STAGES = "  static constexpr int kStages = "
SL = "  constexpr float sl = head_scale<DH>() * kLog2e;\n"
SKEW = SL + ("  if (wg == 1) {  // half a tile late\n"
             "    const long long t0 = clock64();\n"
             "    while (clock64() - t0 < 600) {\n"
             "    }\n"
             "  }\n")
COPIES = '''        copy4_async(st + 4 * i, lse + at, r < Lq);
        copy4_async(st + 4 * (kN + i), delta + at, r < Lq);
      }
      copies_arrive(full);
'''
LOADS = '''        const float l = r < Lq ? lse[at] : 0.f, d = r < Lq ? delta[at] : 0.f;
        asm volatile("st.shared.f32 [%0], %1;" ::"r"(st + 4 * i), "f"(l) : "memory");
        asm volatile("st.shared.f32 [%0], %1;" ::"r"(st + 4 * (kN + i)), "f"(d) : "memory");
      }
      rt::mbar_arrive(full);
'''

PATCHES = {
    "shipped": (),
    "retire": ((TAIL, RETIRE),),
    "s_beside": ((TAIL, S_BESIDE),),
    "ds_in_dp": ((DS_OLD, DS_NEW),),
    "merged": ((ARRAYS, MERGED),),
    "q32": ((QUERIES, QUERIES + "32; // "),),
    "q64": ((QUERIES, QUERIES + "64; // "),),
    "loads": ((COPIES, LOADS),),
    "skew": ((SL, SKEW),),
    "stages8": ((STAGES, STAGES + "8; // "),),
    "together": ((DV_EARLY, ""), (DK_CALL, DV_CALL + DK_CALL)),
}


def variant_source(name: str) -> Path:
    """A patched copy of the package's csrc for variant `name`; returns its
    flash_attention.cu."""
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(REPO / "pose3d_tpu_torch" / "csrc", dst)
    src = dst / "flash_attention.cu"
    text = src.read_text()
    dkv = text.index("// ------------------------------------------------ 14b")
    head, body = text[:dkv], text[dkv:]
    for part in name.split("+"):
        for old, new in PATCHES[part]:
            if old not in body:
                raise SystemExit(f"{part}: the source has no {old.strip()[:60]!r}")
            body = body.replace(old, new, 1)
    src.write_text(head + body)
    return src


def build_all(srcs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    sys.path.insert(0, str(REPO))
    from pose3d_tpu_torch.ops import _build

    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-shared", "-o",
         str(src.with_suffix(".so")), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, src in srcs.items()}
    libs = {}
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        lines = out.splitlines()
        for n, line in enumerate(lines):
            if "flash_dkv_kernel" not in line:
                continue
            dh = line.split("flash_dkv_kernelILi")[1].split("E")[0]
            if "C75" in line:
                print(f"{name} dh {dh}: {line.split(':', 1)[1].split(' in ')[0].strip()}")
            elif "Function properties" in line:
                regs = lines[n + 2].split(":")[1].strip()
                print(f"{name} dh {dh}: {lines[n + 1].strip()}; {regs}")
        lib = ctypes.CDLL(str(srcs[name].with_suffix(".so")))
        lib.flash_fwd_launch.argtypes = [p] * 3 + [ll] * 4 + [p, p] + [i] * 5 + [p]
        lib.flash_bwd_dq_launch.argtypes = [p] * 3 + [ll] * 4 + [p] * 5 + [i] * 5 + [p]
        lib.flash_bwd_dkv_launch.argtypes = [p] * 3 + [ll] * 4 + [p] * 5 + [i] * 5 + [p]
        libs[name] = lib
    return libs


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(PATCHES))
    ap.add_argument("--dh", type=int, default=32, choices=(16, 32, 64))
    args = ap.parse_args()
    names, dh = args.variants.split(","), args.dh
    heads = DIM // dh
    if "shipped" not in names:
        names.insert(0, "shipped")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    libs = build_all({name: variant_source(name) for name in names})

    sys.path.insert(0, str(REPO))
    from pose3d_tpu_torch.ops import flash_attention as F

    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(N_SEQ, LENGTH, 3 * DIM, generator=g).to("cuda", torch.bfloat16)
    dout = torch.randn(N_SEQ, LENGTH, DIM, generator=g).to("cuda", torch.bfloat16)
    q, k, v = F._views(qkv, None)
    strides = F._strides(q, k)
    o = torch.empty(N_SEQ, LENGTH, DIM, dtype=torch.bfloat16, device="cuda")
    lse = torch.empty(N_SEQ, heads, LENGTH, device="cuda")
    delta = torch.empty_like(lse)
    dq, dk, dv = F._views(torch.empty_like(qkv), None)
    shape = (N_SEQ, LENGTH, LENGTH, heads, dh, torch.cuda.current_stream().cuda_stream)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, dout.data_ptr())
    shipped = libs["shipped"]
    if shipped.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
                                o.data_ptr(), lse.data_ptr(), *shape):
        raise SystemExit("flash_fwd_launch failed")
    if shipped.flash_bwd_dq_launch(*head, o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                   dq.data_ptr(), *shape):
        raise SystemExit("flash_bwd_dq_launch failed")

    def dkv(lib):
        if lib.flash_bwd_dkv_launch(*head, lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                    dv.data_ptr(), *shape):
            raise SystemExit("flash_bwd_dkv_launch failed")

    def ms(lib, n=20):
        dkv(lib)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            dkv(lib)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    dkv(shipped)
    torch.cuda.synchronize()
    want = (dk.clone(), dv.clone())
    for name in names:
        dkv(libs[name])
        torch.cuda.synchronize()
        diff = max((a.float() - b.float()).abs().max().item() for a, b in zip((dk, dv), want))
        same = all(torch.equal(a, b) for a, b in zip((dk, dv), want))
        print(f"{name}: dK, dV {'bitwise the shipped' if same else f'max abs diff {diff:.4g}'}")
    order = names + ["shipped"]
    times = {name: [] for name in names}
    for _ in range(3):
        for name in order:
            times[name].append(ms(libs[name]))
    for name in names:
        print(f"{name}: 14b at dh {dh} {statistics.median(times[name]):.4f} ms a call (runs "
              + ", ".join(f"{t:.4f}" for t in times[name]) + ")")


if __name__ == "__main__":
    main()
