"""The port's program spans and its padding counter, on the CPU.

- ``train.debug.span`` is a ``record_function`` range while a profiler
  runs and one shared null context otherwise.
- ``LifterService.lift``, ``lift_sequence`` and the lifter train step
  record their spans, each as a ``user_annotation`` and none as a
  ``cpu_op`` (an op would move the launches under it into the
  benchmark's ``aten`` group).
- ``LifterService.frames_served`` and ``frames_padded`` count every chunk.
- No span name matches a pattern the benchmark attributes device time by
  (``perfbench/names/``), but the one written for it (``^<its name>$``).
"""

import contextlib
import json
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pose3d_tpu_torch.models.lifters import JointTransformerLifter
from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.ops.stblock_train import temporal_train_forward_fused
from pose3d_tpu_torch.pipeline.lift import lift_sequence
from pose3d_tpu_torch.serving import LifterService
from pose3d_tpu_torch.train import debug
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.steps import make_lifter_train_step

REPO = Path(__file__).resolve().parent.parent
SPANS = {
    "pose3d.serve.lift", "pose3d.serve.stage", "pose3d.serve.forward", "pose3d.serve.fetch",
    "pose3d.trunk",
    "pose3d.lift_sequence.clips", "pose3d.lift_sequence.forward",
    "pose3d.lift_sequence.average", "pose3d.temporal.trunk", "pose3d.temporal.fuse",
    "pose3d.train.step", "pose3d.train.forward", "pose3d.train.backward",
    "pose3d.train.optimizer", "pose3d.train.pack",
}


def traced(fn, tmp_path) -> list[dict]:
    """The complete events of ``fn()`` under a CPU profile, from its Chrome
    trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def program_spans(events) -> list[dict]:
    return [e for e in events if e["name"].startswith("pose3d.")]


def inside(e, outer) -> bool:
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_span_is_a_shared_null_context_without_a_profiler():
    a, b = debug.span("pose3d.a"), debug.span("pose3d.b")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert not isinstance(debug.span("pose3d.a"), contextlib.nullcontext)


@pytest.fixture(scope="module")
def service():
    model = JointTransformerLifter(hidden=64, n_blocks=1, heads=2, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    return LifterService(model, None, device="cpu", max_batch=64, min_bucket=8)


def test_a_two_chunk_request_records_its_spans_and_counts(service, tmp_path):
    kp = np.random.default_rng(0).normal(size=(100, 17, 2)).astype(np.float32)
    served, padded = LifterService.frames_served, LifterService.frames_padded
    events = traced(lambda: service.lift(kp), tmp_path)
    # 100 frames: a chunk of 64 in the top bucket, then 36 padded to 64
    assert LifterService.frames_served - served == 100
    assert LifterService.frames_padded - padded == 28
    spans = program_spans(events)
    assert {e["cat"] for e in spans} == {"user_annotation"}
    assert not [e for e in events if e["cat"] == "cpu_op" and e["name"].startswith("pose3d.")]
    (lift,) = [e for e in spans if e["name"] == "pose3d.serve.lift"]
    counts = Counter(e["name"] for e in spans if e is not lift and inside(e, lift))
    assert counts == {"pose3d.serve.stage": 2, "pose3d.serve.forward": 2,
                      "pose3d.serve.fetch": 2}
    served, padded = LifterService.frames_served, LifterService.frames_padded
    service.lift(kp[:5])  # bucket 8
    assert (LifterService.frames_served - served, LifterService.frames_padded - padded) == (5, 3)


@pytest.fixture(scope="module")
def temporal():
    torch.manual_seed(0)
    return TemporalLifter(clip_len=12, n_blocks=2, device="cpu")


def test_a_fused_train_step_records_its_spans(temporal, tmp_path):
    state = create_train_state(temporal, lr=1e-4, optimizer="sgd", grad_clip=1.0,
                               apply=temporal_train_forward_fused)
    step = make_lifter_train_step("mse")
    gen = torch.Generator().manual_seed(1)
    y1, y2 = torch.randn(2, 12, 17, 2, generator=gen), torch.randn(2, 12, 17, 3, generator=gen)
    spans = program_spans(traced(lambda: step(state, y1, y2), tmp_path))
    assert {e["cat"] for e in spans} == {"user_annotation"}
    assert Counter(e["name"] for e in spans) == {
        "pose3d.train.step": 1, "pose3d.train.forward": 1, "pose3d.train.backward": 1,
        "pose3d.train.optimizer": 1, "pose3d.train.pack": 2 * len(temporal.blocks)}
    (outer,) = [e for e in spans if e["name"] == "pose3d.train.step"]
    (fwd,) = [e for e in spans if e["name"] == "pose3d.train.forward"]
    assert all(inside(e, outer) for e in spans)
    assert all(inside(e, fwd) for e in spans if e["name"] == "pose3d.train.pack")


def test_lift_sequence_records_its_spans(temporal, tmp_path):
    kp = np.random.default_rng(2).uniform(0, 1000, size=(30, 17, 2)).astype(np.float32)
    spans = program_spans(traced(lambda: lift_sequence(temporal, kp), tmp_path))
    assert [e["name"] for e in sorted(spans, key=lambda e: e["ts"])] == [
        "pose3d.lift_sequence.clips", "pose3d.lift_sequence.forward",
        "pose3d.lift_sequence.average"]
    assert {e["cat"] for e in spans} == {"user_annotation"}


def test_span_names_are_the_sites_and_match_no_attribution_pattern():
    used = set()
    for path in (REPO / "pose3d_tpu_torch").rglob("*.py"):
        used |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert used == SPANS
    patterns = []
    for path in (REPO / "perfbench" / "names").glob("*/*.json"):
        spec = json.loads(path.read_text())
        patterns += [re.compile(p) for p in spec.get("ops", []) + spec.get("kernels", [])]
    assert patterns
    own = {f"^{re.escape(n)}$" for n in SPANS}
    assert not [(n, p.pattern) for n in SPANS for p in patterns
                if p.search(n) and p.pattern != f"^{re.escape(n)}$"]
    assert {p.pattern for p in patterns} & own == {r"^pose3d\.temporal\.trunk$"}
