"""Driver of ``LifterService.lift``: one client in a closed loop, numpy in
and numpy out, as a user lifting a clip's or a dataset's worth of 2D
detections calls it.

Traffic parameters (``perfbench/traffic/<name>.json``): ``min_frames``,
``max_frames`` (a request's frames, log-uniform), ``sizes_per_cycle``
(a cycle holds the same sizes for every seed, the log-uniform quantiles
(i + 0.5) / n; the seed orders them and places the largest among the
first ``check_window`` requests), ``pool_frames`` (the synthetic
keypoints requests are sliced from), ``check_requests`` (the answers
checked: drawn from the seed, once the window has closed, among those of
the first ``check_window`` requests that it finished, the largest among
them), ``trace_seconds`` and ``attribution_seconds`` (the two traced
windows' lengths).

Set-up makes the weights on the device from the seed in the served
dtype, builds the service (which packs them once) and warms every
bucket up (``warmup()``, then one request a bucket through ``lift``).
The check runs the plain float32 reference over the checked requests
once the service is freed.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from perfbench.harness import compare, synthetic
from perfbench.harness.weights import seeded_params
from perfbench.references import common
from perfbench.references import vit_lifter as ref
from pose3d_tpu_torch.models.lifters import JointTransformerLifter
from pose3d_tpu_torch.ops import lifter as lifter_ops
from pose3d_tpu_torch.serving import LifterService

SPAN = "perfbench.lift"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def cycle_sizes(traffic: dict) -> list[int]:
    """The sizes of one cycle, the same for every seed."""
    lo, hi, n = math.log(traffic["min_frames"]), math.log(traffic["max_frames"]), \
        traffic["sizes_per_cycle"]
    return [int(round(math.exp(lo + (i + 0.5) / n * (hi - lo)))) for i in range(n)]


def plan(traffic: dict, seed: int):
    """(sizes in the order sent, offsets into the pool) of one cycle."""
    rng = np.random.default_rng(seed)
    sizes = np.array(cycle_sizes(traffic))[rng.permutation(traffic["sizes_per_cycle"])]
    big = int(np.argmax(sizes))
    at = int(rng.integers(0, min(traffic["check_window"], len(sizes))))
    sizes[[big, at]] = sizes[[at, big]]
    offsets = rng.integers(0, traffic["pool_frames"] - sizes + 1)
    return sizes.tolist(), offsets.tolist()


def sample(finished: dict, n: int, seed: int) -> list[int]:
    """The answers checked: ``n`` of the finished requests, drawn from the
    seed, the largest among them."""
    ids = sorted(finished)
    big = max(ids, key=lambda i: finished[i][1])
    rest = [i for i in ids if i != big]
    rng = np.random.default_rng([seed, 1])
    return sorted([big, *rng.choice(rest, min(n - 1, len(rest)), replace=False).tolist()])


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, faults=()):
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.phases, self.t_phase = {}, time.perf_counter()
        self.params = seeded_params(ref.param_shapes(cfg), seed, self.device,
                                    DTYPES[cfg["dtype"]])
        self._phase("weights")
        poses = synthetic.synthetic_poses_3d(traffic["pool_frames"],
                                             np.random.default_rng(seed))
        self.pool = synthetic.project_to_2d(poses, camera=seed % 4)
        self.seed = seed
        self.sizes, self.offsets = plan(traffic, seed)
        self._phase("pool")
        model = JointTransformerLifter(
            n_joints=cfg["n_joints"], in_dim=cfg["in_dim"], out_dim=cfg["out_dim"],
            hidden=cfg["hidden"], n_blocks=cfg["n_blocks"], heads=cfg["heads"],
            device=self.device, dtype=DTYPES[cfg["dtype"]])
        self.svc = LifterService(model, self.params, device=self.device,
                                 max_batch=cfg["max_batch"], min_bucket=cfg["min_bucket"])
        for fault in faults:
            fault(self)
        self._phase("service")
        self.svc.warmup()
        for b in self.svc.buckets:
            self.svc.lift(self.pool[:b])
        self._phase("warmup")
        self.launches0, self.window_calls = lifter_ops.trunk.launches, 0
        self.kept = {}
        self._ref = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _phase(self, name: str):
        """Seconds of set-up since the last phase, the device's work in it
        done."""
        self._sync()
        now = time.perf_counter()
        self.phases[name], self.t_phase = now - self.t_phase, now

    def window(self, seconds: float, tracer=None) -> dict:
        n_cycle = len(self.sizes)
        lat, frames, failed, i = [], 0, 0, 0
        calls = []
        span = tracer.span if tracer else (lambda name: contextlib.nullcontext())
        with tracer.window() if tracer else contextlib.nullcontext():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while True:
                size, off = self.sizes[i % n_cycle], self.offsets[i % n_cycle]
                kp = self.pool[off:off + size]
                ts = time.perf_counter()
                try:
                    with span(SPAN):
                        out = self.svc.lift(kp)
                except (RuntimeError, ValueError):
                    failed += 1
                    out = None
                te = time.perf_counter()
                lat.append(te - ts)
                frames += size
                calls += [b for _, b in ref.chunk_buckets(size, self.cfg)]
                if i < self.traffic["check_window"] and out is not None:
                    self.kept[i] = (off, size, out)
                i += 1
                if te >= deadline:
                    break
            t_end = te
        self.window_calls += len(calls)
        self.block_s = [round(sum(lat[k:k + 500]), 4) for k in range(0, len(lat) - 499, 500)]
        return {"attempted": i, "failed": failed,
                "e2e": {"infer_frames_per_s": frames / (t_end - t0),
                        "request_p95_ms": float(np.percentile(lat, 95)) * 1e3},
                "info": {"requests": i, "frames": frames, "calls": calls}}

    def counters(self) -> dict:
        return {"trunk.launches": lifter_ops.trunk.launches - self.launches0,
                "trunk_calls_expected": self.window_calls, "fused": self.svc.fused,
                "setup_phases_s": self.phases, "s_per_500_requests": self.block_s}

    def release(self):
        del self.svc
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _checked(self) -> list[tuple[int, int, np.ndarray]]:
        return [self.kept[i] for i in sample(self.kept, self.traffic["check_requests"], self.seed)]

    def _inputs(self):
        return [torch.from_numpy(self.pool[off:off + size]).to(self.device)
                for off, size, _ in self._checked()]

    def reference(self, precision: str = "f32") -> list[torch.Tensor]:
        """The reference's poses for the checked requests, float32 products
        with TF32 off (``precision`` "fp8" or "int8": a control's)."""
        p32 = {k: v.float() for k, v in self.params.items()}
        mm = common.MATMULS[precision]
        with common.no_tf32():
            return [ref.serve(p32, kp, self.cfg, mm) for kp in self._inputs()]

    def program(self) -> list[torch.Tensor]:
        return [torch.from_numpy(out).to(self.device) for _, _, out in self._checked()]

    def check(self) -> dict[str, float]:
        if not self.kept:
            return {"max_abs_err": float("inf"), "rms_err": float("inf")}
        if self._ref is None:
            self._ref = self.reference()
        return compare.output_gaps(self.program(), self._ref)

    def control(self, precision: str) -> dict[str, float]:
        if self._ref is None:
            self._ref = self.reference()
        return compare.output_gaps(self.reference(precision), self._ref)
