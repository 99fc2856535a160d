"""The readers of the program's spans and counter, on canned traces: the
idle inside the service's stage and fetch spans, the device ms launched
under the train step's pack and optimizer spans (through a PyTorch op
between the span and the launch), the padded share from set counter
values; and none of them reads anything where the program records no
span and keeps no counter."""

import json

import pytest

from perfbench.harness import core, spans, trace
from perfbench.harness.registry import Registry
from perfbench.tests.conftest import REPO, copy_benchmark
from perfbench.tests.test_perfbench_harness import GROUPS, dev, ev
from pose3d_tpu_torch.serving import LifterService

SERVE = [
    ev(trace.WINDOW, "user_annotation", 0, 1000),
    *[e for r in (0, 500) for e in (
        ev("perfbench.lift", "user_annotation", r + 10, 400),
        ev("pose3d.serve.lift", "user_annotation", r + 15, 390),
        ev("pose3d.serve.stage", "user_annotation", r + 20, 100),
        ev("aten::zeros", "cpu_op", r + 25, 10),
        ev("cudaLaunchKernel", "cuda_runtime", r + 30, 5, correlation=r + 1),
        ev("aten::copy_", "cpu_op", r + 50, 60),
        ev("cudaMemcpyAsync", "cuda_runtime", r + 55, 5, correlation=r + 2),
        ev("pose3d.serve.forward", "user_annotation", r + 130, 100),
        ev("pose3d.trunk", "user_annotation", r + 140, 20),
        ev("cudaLaunchKernelExC", "cuda_runtime", r + 145, 5, correlation=r + 3),
        ev("pose3d.serve.fetch", "user_annotation", r + 240, 150),
        ev("aten::copy_", "cpu_op", r + 245, 140),
        ev("cudaMemcpyAsync", "cuda_runtime", r + 250, 5, correlation=r + 4),
        dev("void at::native::vectorized_elementwise_kernel<4>(Args)", "kernel", r + 40, 10,
            r + 1),
        dev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", r + 90, 20, r + 2),
        dev("void pose3d::qkv_kernel<Traits>(Args)", "kernel", r + 150, 200, r + 3),
        dev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", r + 360, 20, r + 4))],
]

TRAIN = [
    ev(trace.WINDOW, "user_annotation", 0, 1000),
    *[e for s in (0, 500) for e in (
        ev("perfbench.step", "user_annotation", s + 5, 490),
        ev("pose3d.train.step", "user_annotation", s + 10, 480),
        ev("pose3d.train.forward", "user_annotation", s + 20, 200),
        ev("pose3d.train.pack", "user_annotation", s + 30, 50),
        ev("aten::to", "cpu_op", s + 35, 40),
        ev("aten::copy_", "cpu_op", s + 40, 30),
        ev("cudaLaunchKernel", "cuda_runtime", s + 45, 5, correlation=s + 1),
        ev("SpatialBlockTrain", "cpu_op", s + 100, 50),
        ev("cudaLaunchKernelExC", "cuda_runtime", s + 110, 5, correlation=s + 2),
        ev("aten::mm", "cpu_op", s + 160, 20),  # the head: under forward, no pack
        ev("cudaLaunchKernel", "cuda_runtime", s + 165, 5, correlation=s + 3),
        ev("pose3d.train.backward", "user_annotation", s + 230, 100),
        ev("pose3d.train.optimizer", "user_annotation", s + 340, 140),
        ev("Optimizer.step#AdamW.step", "user_annotation", s + 345, 130),
        ev("aten::_foreach_mul_", "cpu_op", s + 350, 30),
        ev("cudaLaunchKernel", "cuda_runtime", s + 355, 5, correlation=s + 4),
        dev("void at::native::elementwise_kernel<bf16>(Args)", "kernel", s + 50, 30, s + 1),
        dev("void pose3d::qkv_kernel<Train>(Args)", "kernel", s + 120, 100, s + 2),
        dev("ampere_bf16_gemm", "kernel", s + 225, 10, s + 3),
        dev("void at::native::multi_tensor_apply_kernel<Adam>(Args)", "kernel", s + 400, 40,
            s + 4))],
]


def read(root, name, ctx):
    return Registry(root).reader(name).read(ctx)


def serve_ctx(events, requests=2):
    v = trace.TraceView(events, GROUPS)
    return core.Context(v, {}, v, {"requests": requests}, {}, {})


def test_stage_and_fetch_idle_from_known_spans():
    ctx = serve_ctx(SERVE)
    # stage [20, 120]: the device busy 40-50 and 90-110, idle 70 a request
    assert read(REPO, "stage_idle_ms.infer", ctx) == pytest.approx(70e-3)
    # fetch [240, 390]: the trunk kernel until 350, the copy out 360-380
    assert read(REPO, "fetch_idle_ms.infer", ctx) == pytest.approx((150 - 110 - 20) * 1e-3)
    assert ctx.trace.group_s("trunk") * 1e6 == pytest.approx(400)  # still by kernel name


def test_the_idle_readers_read_nothing_without_the_program_spans():
    ctx = serve_ctx([e for e in SERVE if not e["name"].startswith("pose3d.")])
    assert read(REPO, "stage_idle_ms.infer", ctx) is None
    assert read(REPO, "fetch_idle_ms.infer", ctx) is None


@pytest.fixture
def traced_root(tmp_path):
    """A copy of the benchmark whose host-ops window left ``events``."""
    root = copy_benchmark(tmp_path)

    def write(events):
        out = root / "perfbench" / core.OUT / "host.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"traceEvents": events}))
        return root
    return write


def train_ctx(events, steps=2):
    v = trace.TraceView(events, Registry(REPO).names())
    return core.Context(v, {}, v, {"steps": steps, "clips": 32}, {}, {})


def test_pack_and_optimizer_ms_from_launches_under_nested_spans(traced_root):
    root, ctx = traced_root(TRAIN), train_ctx(TRAIN)
    assert read(root, "pack_ms.train", ctx) == pytest.approx(30e-3)
    assert read(root, "optimizer_ms.train", ctx) == pytest.approx(40e-3)
    # both are PyTorch-launched: part of aten_ms.train, which holds the head too
    assert read(root, "aten_ms.train", ctx) == pytest.approx((30 + 10 + 40) * 1e-3)
    v = spans.view(root / "perfbench" / "metrics" / "pack_ms.train.py")
    assert v is spans.view(root / "perfbench" / "metrics" / "optimizer_ms.train.py")
    assert v.group_s("pose3d.train.forward") * 1e6 == pytest.approx(2 * (100 + 10))


def test_the_train_readers_read_nothing_without_the_program_spans(traced_root):
    events = [e for e in TRAIN if not e["name"].startswith("pose3d.")]
    root, ctx = traced_root(events), train_ctx(events)
    assert read(root, "pack_ms.train", ctx) is None
    assert read(root, "optimizer_ms.train", ctx) is None


def test_pad_share_from_the_counters(monkeypatch):
    ctx = serve_ctx(SERVE)
    monkeypatch.setattr(LifterService, "frames_served", 8_050)
    monkeypatch.setattr(LifterService, "frames_padded", 1_950)
    assert read(REPO, "pad_share_pct.infer", ctx) == pytest.approx(19.5)
    monkeypatch.setattr(LifterService, "frames_served", 0)
    monkeypatch.setattr(LifterService, "frames_padded", 0)
    assert read(REPO, "pad_share_pct.infer", ctx) is None
    monkeypatch.delattr(LifterService, "frames_served")
    assert read(REPO, "pad_share_pct.infer", ctx) is None
