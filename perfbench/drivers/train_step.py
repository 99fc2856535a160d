"""Driver of the temporal lifter's fused train step, as
``cli/train_temporal`` runs it: ``make_lifter_train_step(loss)`` over
``create_train_state(model, lr, apply=temporal_train_forward_fused)``,
fed by the trainer's ``batch_iterator`` and ``prefetch_to_device``.

Traffic parameters: ``batch_clips`` (clips a step), ``pool_clips`` (the
host pool of synthetic clips, reshuffled each pass), ``prefetch_depth``,
``first_steps`` (the steps the check follows), ``warmup_steps`` (more
steps before the window), ``trace_seconds`` and ``attribution_seconds``
(the two traced windows' lengths).

Set-up builds one train state from weights made on the device from the
seed and drives it through the first steps by the window's own call and
feed, reading the loss of each, the first gradient (from AdamW's first
moment after one step: (1 - beta1) g) and the parameters after the last,
before the next step changes them; then the warm-up steps. The window
dispatches steps back to back and synchronises at its end; the plateau
schedule steps on the last loss of each pass over the pool, as the
trainer's epoch does. The check runs the plain float32 reference, and
the same in bfloat16 products, over the same first batches from the same
weights once the state is freed.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench.harness import compare, synthetic
from perfbench.harness.weights import seeded_params
from perfbench.references import common
from perfbench.references import temporal_lifter as ref
from pose3d_tpu_torch.data.feed import batch_iterator, prefetch_to_device
from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.ops import stblock_train
from pose3d_tpu_torch.ops.stblock_train import temporal_train_forward_fused
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.steps import make_lifter_train_step

SPAN = "perfbench.step"
WRAPPERS = ("spatial_fwd", "slab_fwd", "spatial_bwd", "slab_bwd")


def clip_pool(cfg: dict, traffic: dict, seed: int):
    """(2D clips, root-centred 3D clips) of ``pool_clips`` synthetic clips."""
    rng = np.random.default_rng(seed)
    n, t, j = traffic["pool_clips"], cfg["clip_len"], cfg["n_joints"]
    kp3d = synthetic.synthetic_poses_3d(n * t, rng)
    kp2d = synthetic.project_to_2d(kp3d, camera=seed % 4)
    kp3d = kp3d - kp3d[:, :1]
    return kp2d.reshape(n, t, j, 2), kp3d.reshape(n, t, j, 3)


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, faults=()):
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.phases, self.t_phase = {}, time.perf_counter()
        self.params0 = seeded_params(ref.param_shapes(cfg), seed, self.device)
        self._phase("weights")
        model = TemporalLifter(n_joints=cfg["n_joints"], in_dim=cfg["in_dim"],
                               out_dim=cfg["out_dim"], clip_len=cfg["clip_len"],
                               hidden=cfg["hidden"], n_blocks=cfg["n_blocks"],
                               heads=cfg["heads"], device=self.device)
        model.load_state_dict(self.params0, strict=True)
        self.state = create_train_state(model, lr=cfg["lr"], optimizer=cfg["optimizer"],
                                        weight_decay=cfg["weight_decay"],
                                        apply=temporal_train_forward_fused)
        self.step_fn = make_lifter_train_step(cfg["loss"])
        self._phase("state")
        c2, c3 = clip_pool(cfg, traffic, seed)
        self._phase("pool")
        self.per_pass = traffic["pool_clips"] // traffic["batch_clips"]
        self.first_batches = []
        self.feed = prefetch_to_device(self._recorded(batch_iterator(
            (c2, c3), traffic["batch_clips"], shuffle=True, seed=seed)), self.device,
            depth=traffic["prefetch_depth"])
        self.steps_done, self.pass_ends = 0, []
        self._ref = None
        for fault in faults:
            fault(self)
        self._first_steps()
        self._phase("first_steps")
        for _ in range(traffic["warmup_steps"]):
            self._step()
        self._phase("warmup_steps")
        self.launches0 = {w: getattr(stblock_train, w).launches for w in WRAPPERS}
        self.window_steps = 0

    def _recorded(self, batches):
        for y1, y2 in batches:
            if len(self.first_batches) < self.traffic["first_steps"]:
                self.first_batches.append((y1.copy(), y2.copy()))
            yield y1, y2

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _phase(self, name: str):
        """Seconds of set-up since the last phase, the device's work in it
        done."""
        self._sync()
        now = time.perf_counter()
        self.phases[name], self.t_phase = now - self.t_phase, now

    def _step(self) -> dict:
        y1, y2 = next(self.feed)
        m = self.step_fn(self.state, y1, y2)
        self.steps_done += 1
        if self.steps_done % self.per_pass == 0:  # the trainer's epoch end
            self.state.plateau.step(float(m["loss"]))
            self.pass_ends.append(time.perf_counter())
        return m

    def _named(self) -> dict[str, torch.Tensor]:
        return dict(self.state.model.named_parameters())

    def _first_steps(self):
        losses, mpjpe = [], []
        b1 = self.cfg["betas"][0]
        for k in range(self.traffic["first_steps"]):
            m = self._step()
            losses.append(m["loss"])
            mpjpe.append(m["mpjpe_sums"].sum())
            if k == 0:
                opt_state = self.state.optimizer.state
                grad = {n: opt_state[p]["exp_avg"] / (1 - b1) if p in opt_state
                        else torch.zeros_like(p) for n, p in self._named().items()}
                grad_norms = ref.leaf_norms(grad)
                self.first_grad = ref.host_leaves(grad)
        after = {n: p.detach() - self.params0[n] for n, p in self._named().items()}
        self.readings = {"losses": [float(x) for x in losses],
                         "mpjpe": [float(x) for x in mpjpe], "grad": grad_norms,
                         "update": ref.leaf_norms(after)}

    def window(self, seconds: float, tracer=None) -> dict:
        span = tracer.span if tracer else (lambda name: contextlib.nullcontext())
        steps, failed = 0, 0
        with tracer.window() if tracer else contextlib.nullcontext():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while True:
                with span(SPAN):
                    self._step()
                steps += 1
                if time.perf_counter() >= deadline:
                    break
            self._sync()
            t_end = time.perf_counter()
        self.window_steps += steps
        frames = steps * self.traffic["batch_clips"] * self.cfg["clip_len"]
        return {"attempted": steps, "failed": failed,
                "e2e": {"train_frames_per_s": frames / (t_end - t0)},
                "info": {"steps": steps, "clips": self.traffic["batch_clips"]}}

    def counters(self) -> dict:
        out = {f"{w}.launches": getattr(stblock_train, w).launches - self.launches0[w]
               for w in WRAPPERS}
        out["calls_expected_each"] = self.window_steps * self.cfg["n_blocks"]
        out["setup_phases_s"] = self.phases
        ends = self.pass_ends
        out["pass_s"] = [round(b - a, 4) for a, b in zip(ends, ends[1:])]
        return out

    def release(self):
        del self.state, self.feed
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f32") -> tuple[dict, dict]:
        """The reference's readings over the first batches from the same
        weights, float32 with TF32 off (``precision`` "fp8" or "int8": a
        control's), and its first gradient's leaves on the host."""
        batches = [(torch.from_numpy(a).to(self.device), torch.from_numpy(b).to(self.device))
                   for a, b in self.first_batches]
        with common.no_tf32():
            losses, grad, params, mpjpe = ref.train_steps(
                self.params0, batches, self.cfg, common.MATMULS[precision])
        return ({"losses": losses, "mpjpe": mpjpe, "grad": ref.leaf_norms(grad),
                 "update": ref.leaf_norms({k: params[k] - self.params0[k] for k in params})},
                ref.host_leaves(grad))

    def _refs(self) -> tuple:
        """The reference's readings in float32 and in bfloat16, the
        configuration's precision, which scales the gradient's gap."""
        if self._ref is None:
            self._ref = self.reference(), self.reference("bf16")
        return self._ref

    def check(self) -> dict[str, float]:
        return compare.train_gaps((self.readings, self.first_grad), *self._refs())

    def control(self, precision: str) -> dict[str, float]:
        return compare.train_gaps(self.reference(precision), *self._refs())
