"""Chip smoke test of the PyTorch/CUDA port: `python3 chip_smoke.py`.

Drives the port's serving path once on one NVIDIA GPU (Hopper, sm_90a)
at the full width of the default JointTransformerLifter (the reference
MyViT: 17 tokens, hidden 256, 2 blocks, 4 heads, bf16, random weights
from a seed), and fails (non-zero exit, traceback) if any phase fails:

1. device: the card's name and power limit;
2. build: nvcc builds the kernels from ``pose3d_tpu_torch/csrc``;
3. kernel vs plain: the trunk kernel against ``trunk_reference`` on the
   card at B=64 and B=8192, on the embedded tokens of seeded keypoints
   (the main path's trunk input), and frame isolation. Tolerances: the
   fused forward's (B, 17, 3) outputs within atol 5e-2 (the JAX
   package's bf16 budget); the trunk's own outputs, which reach |7|
   where one bf16 step is 2^-5, within 5e-2 + 2^-5 |want|; and the
   kernel's error against an f32 trunk at most 1.5x the plain version's;
4. serving: ``LifterService(...).warmup()`` then requests of N = 1, 33,
   200, 8192, 10000 (the last chunked over the top bucket), each checked
   against the f32 module (atol 0.1) and the plain path (atol 5e-2); the
   trunk's launch count over these requests must be the number of
   batches they make;
5. times at B=8192 with CUDA events, median of 20 runs after warm-up:
   kernel trunk, plain trunk, eager bf16 module, and the service's lift.

Prints one JSON line of kernel records, then as the last line
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result. Imports torch, numpy and ``pose3d_tpu_torch`` only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import pose3d_tpu_torch
from pose3d_tpu_torch.models.lifters import JointTransformerLifter
from pose3d_tpu_torch.ops import _build
from pose3d_tpu_torch.ops import lifter as L
from pose3d_tpu_torch.serving import LifterService

SEED = 0
TOP = 8192
REQUESTS = (1, 33, 200, 8192, 10000)
N_TIMED = 20
KERNEL_ATOL = 5e-2   # kernel vs plain path, (B, 17, 3) outputs (the JAX package's bf16 budget)
# the trunk's outputs reach |7|: a different f32 summation order flips bf16
# roundings that the bf16 residual stream carries on, so the bound grows
# with the value, by 4 to 8 bf16 steps (2^-5 relative)
TRUNK_RTOL = 2 ** -5
F32_ERR_RATIO = 1.5  # kernel's error vs an f32 trunk, relative to the plain version's
F32_ATOL = 0.1       # bf16 path vs the f32 module (test_close_to_f32_flax_apply)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; nothing was run")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, {torch.cuda.device_count()} visible, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def build_phase() -> None:
    here = Path(__file__).resolve().parent
    if Path(pose3d_tpu_torch.__file__).resolve().parent.parent != here:
        sys.exit("chip_smoke: pose3d_tpu_torch does not come from this checkout")
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{_build.library_path().relative_to(here)}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")


def seeded_model(device, dtype):
    model = JointTransformerLifter(device="cpu")
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.to(device=device, dtype=dtype).eval()


def kernel_phase(model) -> float:
    """Kernel vs plain on the card; returns the trunk's max abs error at B=TOP."""
    w = L.pack_weights(model)
    w32 = L.TrunkWeights(w.flat.float(), w.n_blocks)
    gen = torch.Generator().manual_seed(SEED + 1)
    err_top = None
    for batch in (64, TOP):
        kp = torch.rand(batch, 17, 2, generator=gen).to("cuda")
        tokens = L.embed_tokens(model, kp)
        got = L.trunk(tokens, model.pe, w)
        want = L.trunk_reference(tokens, model.pe, w)
        ref32 = L.trunk_reference(tokens.float(), model.pe.float(), w32)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"kernel output not finite at B={batch}")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        excess = (diff - (KERNEL_ATOL + TRUNK_RTOL * want.float().abs())).max().item()
        err32 = (got.float() - ref32).abs().max().item()
        plain32 = (want.float() - ref32).abs().max().item()
        out_err = (L.lifter_forward_fused(model, kp, weights=w)
                   - L.lifter_head(model, want)).abs().max().item()
        log(f"kernel vs plain, B={batch}: trunk max abs err {err:.6g} "
            f"(|want| max {want.float().abs().max().item():.4g}, worst excess over "
            f"5e-2 + 2^-5|want| {excess:.4g}); vs an f32 trunk: kernel "
            f"{err32:.6g}, plain {plain32:.6g}; fused output max abs err "
            f"{out_err:.6g} (atol {KERNEL_ATOL})")
        if excess > 0 or err32 > F32_ERR_RATIO * plain32 or out_err > KERNEL_ATOL:
            raise AssertionError(f"kernel disagrees with its plain version at B={batch}")
        err_top = err
    tokens = L.embed_tokens(model, torch.rand(64, 17, 2, generator=gen).to("cuda"))
    base = L.trunk(tokens, model.pe, w)
    pert = tokens.clone()
    pert[:17] += 1.0
    out = L.trunk(pert, model.pe, w)
    torch.cuda.synchronize()
    if not torch.equal(base[17:], out[17:]) or torch.equal(base[:17], out[:17]):
        raise AssertionError("frame isolation: perturbing frame 0 moved other frames")
    log("kernel frame isolation: ok")
    return err_top


def serving_phase(model, model_f32):
    """Returns (service, the trunk launches the requests made)."""
    svc = LifterService(model, None, device="cuda", max_batch=TOP).warmup()
    if not svc.fused:
        raise AssertionError("the bf16 default lifter is not on the kernel route")
    rng = np.random.default_rng(SEED + 2)
    requests = [rng.random((n, 17, 2)).astype(np.float32) for n in REQUESTS]
    expected = sum(-(-n // TOP) for n in REQUESTS)

    L.trunk.launches = 0
    answers = [svc.lift(kp) for kp in requests]
    launches = L.trunk.launches
    log(f"serving: {len(REQUESTS)} requests, trunk launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError("the requests did not all go through the kernel")

    for kp, got in zip(requests, answers):
        n = len(kp)
        if got.shape != (n, 17, 3) or not np.isfinite(got).all():
            raise AssertionError(f"N={n}: bad answer {got.shape}")
        x = torch.from_numpy(kp).to("cuda")
        ref32 = model_f32(x).cpu().numpy()
        plain = np.concatenate([
            _plain_forward(model, svc, x[i:i + TOP]) for i in range(0, n, TOP)])
        e32 = np.abs(got - ref32).max()
        ep = np.abs(got - plain).max()
        log(f"serving N={n}: max abs err vs f32 module {e32:.6g} "
            f"(atol {F32_ATOL}), vs plain path {ep:.6g} (atol {KERNEL_ATOL})")
        if e32 > F32_ATOL or ep > KERNEL_ATOL:
            raise AssertionError(f"N={n}: answer out of tolerance")
    return svc, launches


def _plain_forward(model, svc, x):
    """The plain path on x padded to its service bucket, as lift pads it."""
    n = len(x)
    b = min(b for b in svc.buckets if b >= n)
    xp = torch.zeros((b, 17, 2), device=x.device)
    xp[:n] = x
    plain = L.lifter_head(model, L.trunk_reference(
        L.embed_tokens(model, xp), model.pe, L.pack_weights(model)))
    return plain[:n].cpu().numpy()


def cuda_ms(fn, n=N_TIMED) -> float:
    """Median ms of fn() over n runs, each fenced by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timing_phase(model, svc) -> dict:
    w = L.pack_weights(model)
    kp = torch.rand(TOP, 17, 2, generator=torch.Generator().manual_seed(SEED + 3))
    kp_dev = kp.to("cuda")
    kp_np = kp.numpy()
    tokens = L.embed_tokens(model, kp_dev)
    t = {
        "kernel_trunk": cuda_ms(lambda: L.trunk(tokens, model.pe, w)),
        "plain_trunk": cuda_ms(lambda: L.trunk_reference(tokens, model.pe, w)),
        "eager_bf16_module": cuda_ms(lambda: model(kp_dev)),
        "fused_forward": cuda_ms(
            lambda: L.lifter_forward_fused(model, kp_dev, weights=w)),
        "service_lift": cuda_ms(lambda: svc.lift(kp_np)),
    }
    for k, ms in t.items():
        log(f"time B={TOP} {k}: {ms:.4f} ms = {TOP / ms * 1e3:.1f} frames/s")
    return t


@torch.inference_mode()
def main() -> None:
    name = device_phase()
    build_phase()
    model = seeded_model("cuda", torch.bfloat16)
    model_f32 = seeded_model("cuda", torch.float32)
    err = kernel_phase(model)
    svc, launches = serving_phase(model, model_f32)
    t = timing_phase(model, svc)
    log(json.dumps({"kernels": [{
        "name": "lifter_trunk",
        "route": "cuda",
        "source": "pose3d_tpu_torch/csrc/lifter_trunk.cu",
        "replaces": "pose3d_tpu/ops/pallas_lifter.py:166",
        "launches": launches,
        "max_abs_err": err,
        "ms": t["kernel_trunk"],
        "plain_ms": t["plain_trunk"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
