"""Driver of ``pipeline/lift.lift_sequence``: one client in a closed loop
lifting videos, numpy in and numpy out, as a user lifts the 2D detections
of a recording (``pipeline/run.py``, ``cli/predict.py``).

Traffic parameters (``perfbench/traffic/<name>.json``): ``min_frames``,
``max_frames`` (a video's frames, log-uniform), ``sizes_per_cycle`` and
``check_window`` (a cycle holds the same sizes for every seed, ordered
by it with the largest among the first ``check_window``:
``drivers/lift.plan``), ``pool_frames`` (the synthetic keypoints videos
are sliced from), ``conf_low``, ``conf_high`` (a model of ``in_dim`` 3
is given per-joint confidences drawn uniform in that range),
``check_requests`` (the videos checked: drawn from the seed, once the
window has closed, among the first ``check_window`` that it finished,
the largest among them), ``trace_seconds`` and ``attribution_seconds``.

The configuration names its model by ``family`` ("spatio_temporal": the
port's ``TemporalLifter``; "dstformer": its ``DSTformer``) and its plain
reference by ``reference`` (a module of ``perfbench/references``); both
are imported when a cell is made, not with this module, so that a
program without the family fails at once. Set-up builds the model in the
served dtype (``dtype``, else ``compute_dtype``) from weights made on the
device from the seed, projects the pool of keypoints to pixels, and lifts
one video of each clip count the cycle holds. ``lift_sequence`` runs
with its defaults: half-clip stride, kernels for a bf16 model. The check
runs the plain float32 reference's forward through the reference's own
clipping and averaging (``references/dstformer.lift_video``) over the
checked videos once the model is freed.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np
import torch

from perfbench.drivers.lift import plan, sample
from perfbench.harness import compare, synthetic
from perfbench.harness.weights import seeded_params
from perfbench.references import common
from pose3d_tpu_torch.models.temporal import clip_starts
from pose3d_tpu_torch.ops import attention, stblock
from pose3d_tpu_torch.pipeline.lift import lift_sequence

SPAN = "perfbench.video"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
IMAGE_SIZE = 1000.0  # pixels a unit of the pool's projected keypoints
MODEL_KEYS = ("n_joints", "in_dim", "out_dim", "clip_len", "hidden", "n_blocks", "heads")
# process-wide call counters the window reads, where the program keeps them
COUNTERS = ((lift_sequence, "videos"), (lift_sequence, "frames"),
            (lift_sequence, "clip_frames"), (attention.packed_flat_attention, "launches"),
            (attention.seq_attention, "launches"), (stblock.spatial_block, "launches"),
            (stblock.temporal_slab, "launches"))


def build_model(cfg: dict, device, dtype):
    """The configuration's model, its family's module imported here."""
    keys = MODEL_KEYS
    if cfg["family"] == "dstformer":
        from pose3d_tpu_torch.models.dstformer import DSTformer as cls
        keys += ("rep_dim", "mlp_ratio", "ln_eps")
    elif cfg["family"] == "spatio_temporal":
        from pose3d_tpu_torch.models.temporal import TemporalLifter as cls
    else:
        raise ValueError(f"no video model of family {cfg['family']!r}")
    return cls(**{k: cfg[k] for k in keys}, device=device, dtype=dtype)


def counts() -> dict[str, int]:
    """The program's counters that exist, by name."""
    return {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in COUNTERS
            if hasattr(fn, attr)}


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, faults=()):
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.phases, self.t_phase = {}, time.perf_counter()
        dtype = DTYPES[cfg.get("dtype") or cfg["compute_dtype"]]
        self.model = build_model(cfg, self.device, dtype).eval()
        self.ref = importlib.import_module(f"perfbench.references.{cfg['reference']}")
        self.params = seeded_params(self.ref.param_shapes(cfg), seed, self.device, dtype)
        self.model.load_state_dict(self.params, strict=True)
        self._phase("weights")
        rng = np.random.default_rng(seed)
        n = traffic["pool_frames"]
        poses = synthetic.synthetic_poses_3d(n, rng)
        pool = synthetic.project_to_2d(poses, camera=seed % 4) * IMAGE_SIZE
        if cfg["in_dim"] == 3:
            conf = rng.uniform(traffic["conf_low"], traffic["conf_high"], (n, cfg["n_joints"], 1))
            pool = np.concatenate([pool, conf.astype(np.float32)], axis=-1)
        self.pool = pool
        self.seed = seed
        self.sizes, self.offsets = plan(traffic, seed)
        self.clips = [self.n_clips(size) for size in self.sizes]
        self._phase("pool")
        self.undo = []
        for fault in faults:
            fault(self)
        by_clips = {}
        for size, clips in zip(self.sizes, self.clips):
            by_clips.setdefault(clips, size)
        for size in by_clips.values():
            lift_sequence(self.model, self.pool[:size], IMAGE_SIZE)
        self._phase("warmup")
        self.counts0 = counts()
        self.kept = {}
        self._ref = None

    def n_clips(self, frames: int) -> int:
        length = min(self.cfg["clip_len"], frames)
        return len(clip_starts(frames, length, max(length // 2, 1)))

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
        lat, frames, failed, i, clips = [], 0, 0, 0, []
        span = tracer.span if tracer else (lambda name: contextlib.nullcontext())
        before = counts()
        with tracer.window() if tracer else contextlib.nullcontext():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while True:
                size, off = self.sizes[i % n_cycle], self.offsets[i % n_cycle]
                kp = self.pool[off:off + size]
                ts = time.perf_counter()
                try:
                    with span(SPAN):
                        out = lift_sequence(self.model, kp, IMAGE_SIZE)
                except (RuntimeError, ValueError):
                    failed += 1
                    out = None
                te = time.perf_counter()
                lat.append(te - ts)
                frames += size
                clips.append(self.clips[i % n_cycle])
                if i < self.traffic["check_window"] and out is not None:
                    self.kept[i] = (off, size, out)
                i += 1
                if te >= deadline:
                    break
            t_end = te
        after = counts()
        return {"attempted": i, "failed": failed,
                "e2e": {"infer_frames_per_s": frames / (t_end - t0),
                        "request_p95_ms": float(np.percentile(lat, 95)) * 1e3},
                "info": {"requests": i, "frames": frames, "clips": clips,
                         "clip_frames": after.get("lift_sequence.clip_frames", 0)
                         - before.get("lift_sequence.clip_frames", 0)}}

    def counters(self) -> dict:
        now = counts()
        return {**{k: v - self.counts0[k] for k, v in now.items()},
                "setup_phases_s": self.phases}

    def release(self):
        for undo in self.undo:
            undo()
        self.undo = []
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _checked(self) -> list[tuple[int, int, np.ndarray]]:
        return [self.kept[i] for i in sample(self.kept, self.traffic["check_requests"], self.seed)]

    def _inputs(self):
        return [torch.from_numpy(self.pool[off:off + size]).to(self.device)
                for off, size, _ in self._checked()]

    def reference(self, precision: str = "f32") -> list[torch.Tensor]:
        """The reference's poses for the checked videos, float32 products
        with TF32 off (``precision`` "fp8" or "int8": a control's)."""
        from perfbench.references.dstformer import lift_video
        p32 = {k: v.float() for k, v in self.params.items()}
        mm = common.MATMULS[precision]
        with common.no_tf32(), torch.no_grad():
            return [lift_video(self.ref.forward, p32, kp, self.cfg, mm, IMAGE_SIZE)
                    for kp in self._inputs()]

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
