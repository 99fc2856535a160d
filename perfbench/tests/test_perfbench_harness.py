"""The harness's own checks: it finds what a later change adds by name,
its trace arithmetic on a canned trace, its exit without a card, and its
check: ``correct`` true on the CPU copy's sound runs and false for each
fault the cells can have and for the control."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench.harness import compare, core, faults, trace
from perfbench.harness.registry import Registry
from perfbench.tests.conftest import REPO

# ------------------------------------------------------------ found by name


def test_a_new_configuration_cell_and_metric_are_found(small_root):
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    cfg = json.loads((small_root / "perfbench/configs/vit_lifter.json").read_text())
    cfg["name"] = "vit_lifter_copy"
    (small_root / "perfbench/configs/vit_lifter_copy.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "vit_lifter_copy", "source": "https://example.org/x",
                             "file": "perfbench/configs/vit_lifter_copy.json", "reduced": [],
                             "why": "a copy"})
    cell = json.loads((small_root / "perfbench/cells/vit.serve.json").read_text())
    cell.update(name="vit_copy.serve", config="vit_lifter_copy")
    (small_root / "perfbench/cells/vit_copy.serve.json").write_text(json.dumps(cell))
    bench["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "chips",
                                                     "why")})
    (small_root / "perfbench/metrics/requests_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.info['requests'])\n")
    bench["per_layer"].append({"name": "requests_traced", "unit": "requests", "better": "higher",
                               "source": "device_trace", "layer": "entry points",
                               "moves": "request_p95_ms", "workloads": ["vit_copy.serve"]})
    for e in bench["end_to_end"]:
        if "vit.serve" in e.get("workloads", []):
            e["workloads"].append("vit_copy.serve")
    (small_root / "perfbench/names/trunk/renamed.json").write_text(
        json.dumps({"ops": [], "kernels": ["trunk_v2_kernel"]}))
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = Registry(small_root)
    assert reg.workload("vit_copy.serve")["config"] == "vit_lifter_copy"
    assert reg.config("vit_lifter_copy")["name"] == "vit_lifter_copy"
    assert "requests_traced" in [m["name"] for m in reg.per_layer("vit_copy.serve")]
    assert "requests_traced" not in [m["name"] for m in reg.per_layer("vit.serve")]
    assert "trunk_v2_kernel" in reg.names()["trunk"]["kernels"]
    assert "qkv_kernel" in reg.names()["trunk"]["kernels"]
    res, _ = core.run(reg, "vit_copy.serve", 3, 0.2, True, "cpu", time.perf_counter())
    assert res["metrics"]["requests_traced"]["value"] > 0


def test_a_cell_file_must_agree_with_benchmark_json(small_root):
    cell = json.loads((small_root / "perfbench/cells/vit.serve.json").read_text())
    cell["chips"] = 4
    (small_root / "perfbench/cells/vit.serve.json").write_text(json.dumps(cell))
    with pytest.raises(ValueError, match="chips"):
        Registry(small_root).workload("vit.serve")


def test_every_metric_has_a_reader_and_its_cells_report_what_it_moves():
    reg = Registry(REPO)
    for m in reg.bench["per_layer"]:
        assert callable(reg.reader(m["name"]).read)
    for w in reg.bench["workloads"]:
        reg.workload(w["name"])
        assert {m["name"] for m in reg.end_to_end(w["name"])} >= {"setup_s"}
        for m in reg.per_layer(w["name"]):
            assert m["moves"] in {e["name"] for e in reg.end_to_end(w["name"])}

# ------------------------------------------------------------ canned trace


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def dev(name, cat, ts, dur, corr):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


CANNED = [
    ev(trace.WINDOW, "user_annotation", 0, 1000),
    ev("perfbench.lift", "user_annotation", 10, 480),
    ev("aten::mul", "cpu_op", 20, 40),
    ev("cudaLaunchKernel", "cuda_runtime", 30, 5, correlation=1),
    ev("cudaLaunchKernelExC", "cuda_runtime", 100, 5, correlation=2),  # ctypes: no op
    ev("cudaMemcpyAsync", "cuda_runtime", 300, 5, correlation=3),
    ev("SpatialBlockTrain", "cpu_op", 500, 100),
    ev("aten::empty", "cpu_op", 505, 5),
    ev("cudaLaunchKernelExC", "cuda_runtime", 520, 5, correlation=4),
    ev("autograd::engine::evaluate_function: SpatialBlockTrainBackward", "cpu_op", 600, 300,
       tid=2),
    ev("cudaLaunchKernelExC", "cuda_runtime", 610, 5, tid=2, correlation=5),
    ev("cudaLaunchKernel", "cuda_runtime", 950, 5, correlation=6),  # under no span
    dev("elementwise_kernel", "kernel", 40, 60, 1),
    dev("void pose3d::qkv_kernel<Traits>(Args)", "kernel", 110, 100, 2),
    dev("Memcpy DtoH", "gpu_memcpy", 310, 40, 3),
    dev("void pose3d::qkv_kernel<Train>(Args)", "kernel", 530, 50, 4),
    dev("void pose3d::gemm_kernel<true, true>(Args)", "kernel", 620, 200, 5),
    dev("mystery_kernel", "kernel", 960, 80, 6),  # runs past the window's end
]
GROUPS = {"trunk": {"ops": [], "kernels": ["qkv_kernel"]},
          "stblock_fwd": {"ops": ["^SpatialBlockTrain$"], "kernels": []},
          "stblock_bwd": {"ops": ["SpatialBlockTrainBackward"], "kernels": []}}


def test_canned_trace_attribution_and_idle():
    v = trace.TraceView(CANNED, GROUPS)
    assert v.window_s == pytest.approx(1000e-6)
    groups = {g: v.group_s(g) * 1e6 for g in ("aten", "trunk", "stblock_fwd", "stblock_bwd",
                                             "other")}
    # the memcpy is launched under the lift span alone, by no PyTorch op and
    # no trunk kernel name: "other"; the last kernel is clipped at 1000
    assert groups == pytest.approx({"aten": 60, "trunk": 100, "stblock_fwd": 50,
                                    "stblock_bwd": 200, "other": 40 + 40})
    assert v.busy_s * 1e6 == pytest.approx(60 + 100 + 40 + 50 + 200 + 40)
    assert v.spans("perfbench.lift") == [(10.0, 490.0)]
    assert v.busy_within(10, 490) == pytest.approx(60 + 100 + 40)
    b = v.breakdown()
    assert b["device_ops"][0] == ["pose3d::gemm_kernel<true, true>", pytest.approx(200e-6)]
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx((1000 - 490) * 1e-6)
    assert gaps == pytest.approx({"host: perfbench.lift": (10 + 100 + 180) * 1e-6,
                                  "host: SpatialBlockTrain": 40e-6,
                                  "host: (no span)": (40 + 140) * 1e-6})


def test_a_trace_without_host_ops():
    """The device's work alone: busy is every device event; the window is
    the host's clock."""
    events = [e for e in CANNED if e["cat"] in trace.DEVICE_CATS]
    v = trace.TraceView(events, GROUPS, window_s=2e-3)
    assert v.window_s == pytest.approx(2e-3)
    assert v.busy_s * 1e6 == pytest.approx(60 + 100 + 40 + 50 + 200 + 80)
    assert v.n_device_events() == 6
    assert v.group_s("trunk") * 1e6 == pytest.approx(100 + 50)  # by kernel name alone


def test_canned_trace_metrics():
    reg = Registry(REPO)
    v = trace.TraceView(CANNED, GROUPS)
    vit, tem = reg.config("vit_lifter"), reg.config("temporal_lifter")
    serve = core.Context(v, {"requests": 2, "frames": 600}, v,
                         {"requests": 1, "calls": [1024]}, vit, {})
    read = lambda name, ctx: reg.reader(name).read(ctx)
    assert read("idle_pct.infer", serve) == pytest.approx(100 * (1 - 490 / 1000))
    assert read("aten_ms.infer", serve) == pytest.approx(0.060)
    assert read("host_ms.infer", serve) == pytest.approx((1000 - 490) / 1000 / 2)
    bound = core.bounds.trunk_call_bound(vit, 1024)[0]
    assert read("trunk_roofline_pct", serve) == pytest.approx(100 * bound / 100e-6)
    assert read("mfu_pct.infer", serve) == pytest.approx(
        100 * 600 * core.bounds.vit_frame_flops(vit) / (1e-3 * 989e12))
    train = core.Context(v, {"steps": 2, "clips": 16}, v, {"steps": 2, "clips": 16}, tem, {})
    assert read("launches.train", train) == pytest.approx(6 / 2)
    fwd = sum(b for b, _ in core.bounds.sub_block_fwd_bounds(tem, 16).values())
    assert read("stblock_fwd_roofline_pct.train", train) == pytest.approx(
        100 * 2 * 5 * fwd / 50e-6)
    empty = core.Context(v, {"steps": 0, "clips": 16}, v, {"steps": 0, "clips": 16}, tem, {})
    assert read("stblock_bwd_roofline_pct", empty) is None

# ------------------------------------------------------------ no card


def test_without_a_card_it_exits_nonzero_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(REPO / "perfbench/run.py"), "--workload",
                          "vit.serve", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_without_the_program_it_exits_nonzero(tmp_path):
    from perfbench.tests.conftest import copy_benchmark
    root = copy_benchmark(tmp_path)
    out = subprocess.run([sys.executable, str(root / "perfbench/run.py"), "--workload",
                          "vit.serve", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=root,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "correct" not in out.stdout

# ------------------------------------------------------------ the check


def test_a_leaf_difference_reads_noise_that_a_gap_of_norms_misses():
    """Unbiased noise of 10% a leaf moves its norm by about half a percent,
    and its difference by the whole 10%."""
    gen = torch.Generator().manual_seed(0)
    ref = {k: torch.randn(4096, generator=gen) for k in "abc"}
    prog = {k: v + 0.1 * torch.randn(4096, generator=gen) for k, v in ref.items()}
    norms = {k: float(v.norm()) for k, v in ref.items()}
    gaps = compare.leaf_gaps({k: float(v.norm()) for k, v in prog.items()}, norms, list(ref))
    diffs = compare.leaf_diffs(prog, ref, norms, list(ref))
    assert max(gaps.values()) < 0.02
    assert min(diffs.values()) == pytest.approx(0.1, rel=0.1)


def run_small(root, workload, faults=()):
    res, _ = core.run(Registry(root), workload, 2**31 + 11, 0.2, False, "cpu",
                      time.perf_counter(), faults)
    return res


@pytest.mark.parametrize("workload", ["vit.serve", "temporal.train"])
def test_a_sound_run_is_correct(small_root, workload):
    res = run_small(small_root, workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in Registry(small_root).end_to_end(workload)}


@pytest.mark.parametrize("workload, fault", [
    ("vit.serve", f) for f in faults.FAULTS["lift"]] + [
    ("temporal.train", f) for f in faults.FAULTS["train_step"]])
def test_each_fault_is_not_correct(small_root, workload, fault):
    res = run_small(small_root, workload, (fault,))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ["vit.serve", "temporal.train"])
def test_the_control_is_not_correct(small_root, workload):
    """The reference in the program's place with the cell's control
    precision reads past a limit of the cell on each of three seeds."""
    reg = Registry(small_root)
    cell = reg.workload(workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    for seed in (1, 2, 3):
        c = reg.driver(traffic["driver"]).Cell(cfg, traffic, seed, torch.device("cpu"))
        if workload == "vit.serve":
            c.window(0.2)
        c.release()
        gaps = c.control(cell["control"])
        assert any(gaps[k] > limit for k, limit in cell["limits"].items()), gaps


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, str(REPO / "perfbench/run.py"), "--workload",
                          "vit.serve", "--seed", "7", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
