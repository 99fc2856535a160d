"""Observability and failure detection: the port of
``pose3d_tpu/train/debug.py``.

- ``profile``: a ``torch.profiler`` trace of the enclosed block, written
  to ``log_dir`` or to ``$POSE3D_PROFILE`` (off when neither is set).
- ``span``: a named range in that trace (``record_function``, a
  ``user_annotation`` event) while a profiler runs, nothing otherwise.
  The program's spans, each ``pose3d.``-prefixed, and their sites:
  ``serve.lift`` (all of ``LifterService.lift``), ``serve.stage`` (a
  chunk's bucket, zero-filled and copied in), ``serve.forward`` (its
  forward), ``serve.fetch`` (its copy out); ``trunk`` (the trunk kernels'
  launch, ``ops/lifter.trunk_scratch``); ``lift_sequence.clips``,
  ``.forward``, ``.average`` (``pipeline/lift.lift_sequence``);
  ``temporal.trunk`` (the blocks of a served temporal forward: the
  sub-block launches of ``ops/stblock.temporal_forward_fused``, the block
  loop of ``models/dstformer.DSTformer``), ``temporal.fuse`` (each of the
  DSTformer's stream fusions, inside ``temporal.trunk``);
  ``train.step`` (``steps.make_lifter_train_step``'s step),
  ``train.forward`` (its apply and loss), ``train.backward`` and
  ``train.optimizer`` (``steps.apply_gradients``), ``train.pack`` (each
  half's weight pack in ``ops/stblock_train.temporal_train_forward_fused``).
- ``nan_check_mode``: the first NaN or infinity raises, in the forward
  (a hook on every module's output) and in the backward (autograd's
  anomaly mode).
- ``assert_finite``: warns with the tensor's name where it holds a
  non-finite value, and returns it unchanged.
- ``StepTimer``: steps/s and items/s over a window, synchronising the
  result's device once a window.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings

import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def profile(log_dir=None):
    """A ``torch.profiler`` trace (CPU, and CUDA where there is a card) of
    the enclosed block, exported for TensorBoard under ``log_dir``."""
    log_dir = log_dir or os.environ.get("POSE3D_PROFILE")
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))):
        yield


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler is on,
    else one shared null context: no allocation and no dispatcher call
    when nothing records. torch offers no check of whether the profiler
    records host events, so under a device-only profile the range is
    entered and records nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name)
    return _NO_SPAN


def _raise_on_non_finite(module, inputs, output):
    for t in output if isinstance(output, (tuple, list)) else (output,):
        if isinstance(t, torch.Tensor) and t.is_floating_point() and not torch.isfinite(t).all():
            raise FloatingPointError(f"non-finite output of {type(module).__name__}")


@contextlib.contextmanager
def nan_check_mode(enable: bool = True):
    """Raise at the first non-finite value: a forward hook on every module
    checks its output, and autograd's anomaly mode checks the backward."""
    if not enable:
        yield
        return
    handle = torch.nn.modules.module.register_module_forward_hook(_raise_on_non_finite)
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        handle.remove()


def assert_finite(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """Warn where ``x`` holds a NaN or an infinity; returns ``x``."""
    if not torch.isfinite(x).all():
        warnings.warn(f"non-finite values in {name}", RuntimeWarning, stacklevel=2)
    return x


class StepTimer:
    """Throughput probe: the first ``tick`` starts the clock; every
    ``window`` ticks after it synchronise the result's device and return
    {"steps_per_s", "items_per_s"}; the others return None."""

    def __init__(self, window: int = 50):
        self.window = window
        self.count = 0
        self.items = 0
        self.t0 = None

    @staticmethod
    def _sync(result) -> None:
        tensors = [t for t in (result.values() if isinstance(result, dict) else [result])
                   if isinstance(t, torch.Tensor)]
        for t in tensors:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
                return

    def tick(self, result, batch_size: int = 0):
        if self.t0 is None:
            self._sync(result)
            self.t0 = time.perf_counter()
            self.count = 0
            self.items = 0
            return None
        self.count += 1
        self.items += batch_size
        if self.count % self.window:
            return None
        self._sync(result)
        dt = time.perf_counter() - self.t0
        return {"steps_per_s": self.count / dt,
                "items_per_s": self.items / dt if self.items else None}
