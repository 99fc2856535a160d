"""MotionBERT's DSTformer in the port (``models/dstformer.py``), its route
through ``pipeline/lift.lift_sequence``, and the ``motionbert.video`` and
``temporal.video`` cells' own pieces, on the CPU.

- The port's ``DSTformer`` against the benchmark's plain f32 reference
  (``perfbench/references/dstformer.py``) on seeded weights at a small
  size: the forward on both routes and the module route's gradients, the
  fusion's weights, the parameter names.
- ``lift_sequence`` on (T, 17, 3) keypoints against the reference's own
  clipping and averaging; its counters; ``lift_video_json``'s
  confidences; the spans of both served temporal forwards.
- The video driver's plan, its lazy imports, its check against each of
  its faults, and ``bounds_video``'s counts at the published widths.
"""

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.drivers import lift as lift_driver
from perfbench.harness import bounds, bounds_video, core, faults_video
from perfbench.harness.registry import Registry
from perfbench.references import dstformer as ref
from perfbench.references import temporal_lifter as temporal_ref
from perfbench.tests.conftest import copy_benchmark
from pose3d_tpu_torch.models.dstformer import DSTformer, fuse
from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.ops import attention, stblock
from pose3d_tpu_torch.pipeline.lift import lift_sequence, lift_video_json

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(n_joints=17, in_dim=3, out_dim=3, clip_len=27, hidden=64, rep_dim=64, n_blocks=2,
             heads=4, mlp_ratio=2, ln_eps=1e-6)
# f32 on both sides, the sums in other orders: a few ulps of outputs ~2
ATOL = 1e-4


def small_model(dtype=torch.float32, seed=0) -> DSTformer:
    return DSTformer(**SMALL, device="cpu", dtype=dtype).init_weights(
        torch.Generator().manual_seed(seed))


def params(model) -> dict:
    return {k: v.detach().float().clone() for k, v in model.state_dict().items()}


def keypoints(frames: int, seed: int = 0) -> np.ndarray:
    """(frames, 17, 3) pixels and confidences."""
    rng = np.random.default_rng(seed)
    kp = rng.uniform(0, 1000, (frames, 17, 3)).astype(np.float32)
    kp[..., 2] = rng.uniform(0.3, 1.0, (frames, 17))
    return kp


@pytest.fixture(scope="module")
def model():
    return small_model()


# ------------------------------------------------------------ the model


def test_state_dict_names_are_the_references(model):
    shapes = ref.param_shapes(SMALL)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    published = DSTformer(device="meta")
    assert sum(p.numel() for p in published.parameters()) == 42_466_317


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_matches_the_reference(model, use_kernels):
    x = torch.from_numpy(keypoints(3 * 27, 1).reshape(3, 27, 17, 3) / 1000)
    with torch.no_grad():
        got = model(x, use_kernels=use_kernels)
        want = ref.forward(params(model), x, SMALL)
    assert got.dtype == torch.float32
    assert want.abs().max() > 0.5
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_module_gradients_match_the_reference(model):
    x = torch.from_numpy(keypoints(2 * 27, 2).reshape(2, 27, 17, 3) / 1000)
    w = torch.randn(2, 27, 17, 3, generator=torch.Generator().manual_seed(3))
    model.zero_grad()
    (model(x) * w).sum().backward()
    p = {k: v.requires_grad_(True) for k, v in params(model).items()}
    grads = torch.autograd.grad((ref.forward(p, x, SMALL) * w).sum(), list(p.values()))
    got = dict(model.named_parameters())
    for (name, want) in zip(p, grads):
        # f32 sums in other orders: relative to the leaf's largest entry
        scale = float(want.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(got[name].grad, want, atol=1e-4 * scale, rtol=0, msg=name)


def test_fusion_weights_sum_to_one_and_match_the_reference(model):
    gen = torch.Generator().manual_seed(4)
    s, u = torch.randn(2, 5, 17, 64, generator=gen), torch.randn(2, 5, 17, 64, generator=gen)
    with torch.no_grad():
        h, a = fuse(model.ts_attn[1], s, u)
    assert a.shape == (2, 5, 17, 2)
    torch.testing.assert_close(a.sum(-1), torch.ones(2, 5, 17))
    assert float(a.min()) > 0 and float((a[..., 0] - a[..., 1]).abs().max()) > 0.05
    torch.testing.assert_close(a, ref.fusion_weights(params(model), 1, s, u), atol=1e-6, rtol=0)
    torch.testing.assert_close(h, s * a[..., :1] + u * a[..., 1:])


def test_a_bf16_model_sends_every_attention_through_the_kernels(monkeypatch):
    calls = Counter()
    for name in ("packed_flat_attention", "seq_attention"):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, _fn=fn, _n=name, **k: (calls.update([_n]), _fn(*a, **k))[1])
    m = DSTformer(**dict(SMALL, clip_len=81), device="cpu", dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(5))
    out = lift_sequence(m, keypoints(100, 5))
    assert out.shape == (100, 17, 3) and np.isfinite(out).all()
    # 2 blocks x 2 streams: 4 spatial and 4 temporal sub-blocks, L = 81 > 64
    assert calls == {"packed_flat_attention": 4, "seq_attention": 4}


# ------------------------------------------------------------ lift_sequence


@pytest.mark.parametrize("frames", [20, 70, 100])
def test_lift_sequence_equals_the_references_clipping(model, frames):
    kp = keypoints(frames, frames)
    got = lift_sequence(model, kp)
    want = ref.lift_video(ref.forward, params(model), torch.from_numpy(kp), SMALL)
    np.testing.assert_allclose(got, want.numpy(), atol=ATOL, rtol=0)


def test_lift_sequence_counts_videos_frames_and_clip_frames(model):
    before = (lift_sequence.videos, lift_sequence.frames, lift_sequence.clip_frames)
    lift_sequence(model, keypoints(70))  # clips at 0, 13, 26, 39 and the tail at 43
    lift_sequence(model, keypoints(20))  # one clip of 20
    lift_sequence(model, keypoints(0))
    after = (lift_sequence.videos, lift_sequence.frames, lift_sequence.clip_frames)
    assert tuple(a - b for a, b in zip(after, before)) == (3, 90, 5 * 27 + 20)


def test_lift_sequence_refuses_keypoints_of_another_width(model):
    with pytest.raises(ValueError, match="in_dim 3"):
        lift_sequence(model, keypoints(30)[..., :2])


@pytest.mark.parametrize("in_dim", [2, 3])
def test_lift_video_json_feeds_the_confidences_to_a_three_channel_model(tmp_path, in_dim):
    kp = keypoints(40, 6)
    records = [{"keypoints": f.tolist(), "score": 0.9} for f in kp]
    path = tmp_path / "video.json"
    path.write_text(json.dumps(records))
    m = (small_model(seed=7) if in_dim == 3 else
         TemporalLifter(clip_len=27, n_blocks=1, hidden=64, heads=4, device="cpu"))
    got = lift_video_json(m, path, tmp_path / "out.npy")
    want = lift_sequence(m, kp[..., :in_dim])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)
    if in_dim == 3:  # the confidences reach the model
        assert np.abs(got - lift_sequence(m, np.concatenate(
            [kp[..., :2], np.ones_like(kp[..., 2:])], -1))).max() > 1e-4


# ------------------------------------------------------------ spans


def traced_spans(fn, tmp_path) -> list[dict]:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X" and e["name"].startswith("pose3d.")),
                  key=lambda e: e["ts"])


def inside(e, outer) -> bool:
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_a_dstformer_forward_records_its_trunk_and_fusions(model, tmp_path):
    spans = traced_spans(lambda: lift_sequence(model, keypoints(30)), tmp_path)
    assert {e["cat"] for e in spans} == {"user_annotation"}
    names = Counter(e["name"] for e in spans)
    assert names["pose3d.temporal.trunk"] == 1 and names["pose3d.temporal.fuse"] == 2
    (trunk,) = [e for e in spans if e["name"] == "pose3d.temporal.trunk"]
    (fwd,) = [e for e in spans if e["name"] == "pose3d.lift_sequence.forward"]
    assert inside(trunk, fwd)
    assert all(inside(e, trunk) for e in spans if e["name"] == "pose3d.temporal.fuse")


def test_the_fused_forward_records_its_trunk(tmp_path):
    m = TemporalLifter(clip_len=12, n_blocks=1, device="cpu", dtype=torch.bfloat16)
    spans = traced_spans(lambda: lift_sequence(m, np.ones((30, 17, 2), np.float32)), tmp_path)
    assert [e["name"] for e in spans] == [
        "pose3d.lift_sequence.clips", "pose3d.lift_sequence.forward", "pose3d.temporal.trunk",
        "pose3d.lift_sequence.average"]


def test_the_fused_forward_packs_every_block_before_its_trunk(monkeypatch):
    """The default packs are made up front, outside ``pose3d.temporal.trunk``,
    so that the span holds the sub-blocks' launches alone; the answer is
    the one of weights packed by the caller."""
    m = TemporalLifter(clip_len=12, n_blocks=2, device="cpu", dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(10))
    x = torch.from_numpy(keypoints(2 * 12, 10)[..., :2].reshape(2, 12, 17, 2) / 1000)
    want = stblock.temporal_forward_fused(m, x, weights=stblock.pack_temporal_lifter(m))
    order = []
    for name in ("pack_spatial_weights", "pack_temporal_weights", "spatial_block",
                 "temporal_slab"):
        fn = getattr(stblock, name)
        monkeypatch.setattr(stblock, name,
                            lambda *a, _fn=fn, _n=name, **k: (order.append(_n), _fn(*a, **k))[1])
    got = stblock.temporal_forward_fused(m, x)
    assert order == 2 * ["pack_spatial_weights", "pack_temporal_weights"] + 2 * [
        "spatial_block", "temporal_slab"]
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# ------------------------------------------------------------ the benchmark's pieces


def test_bounds_video_at_the_published_widths():
    reg = Registry(REPO)
    mb, tl = reg.config("motionbert"), reg.config("temporal_lifter")
    # 5 x (2 streams x (2 x 17 rows x 4.19 MFLOP + 0.59 + 8.46 MFLOP attention) + a fusion),
    # the embed and the 512-wide head
    assert bounds_video.clip_frame_flops(mb) == 1_525_950_464
    # the temporal lifter's is bounds.temporal_forward_flops shared out over a clip's frames
    assert bounds_video.clip_frame_flops(tl) == pytest.approx(
        bounds.temporal_forward_flops(tl, 1) / 243, rel=1e-12)
    got = {k: b for k, (b, _) in bounds_video.sub_block_bounds(mb, 16).items()}
    assert got == pytest.approx({"spatial": 2.8264e-4, "temporal": 3.1357e-4}, rel=1e-4)
    # the temporal lifter's served sub-blocks are its training forwards' products
    assert {k: b for k, (b, _) in bounds_video.sub_block_bounds(tl, 16).items()} == \
        pytest.approx({k: b for k, (b, _) in bounds.sub_block_fwd_bounds(tl, 16).items()})
    assert bounds_video.trunk_bound_s(mb, 16) == pytest.approx(20 / 2 * sum(got.values()))
    assert bounds_video.fusion_bound(mb, 16) == (pytest.approx(6.0612e-5, rel=1e-4), "bytes")


def test_the_video_plan_is_the_same_sizes_for_every_seed():
    traffic = Registry(REPO).traffic("video")
    want = sorted(lift_driver.cycle_sizes(traffic))
    assert len(want) == 256 and want[0] >= 1000 and want[-1] <= 6000
    for seed in (1, 2, 2 ** 31 + 11, 3 * 10 ** 9):
        sizes, offsets = lift_driver.plan(traffic, seed)
        assert sorted(sizes) == want
        assert max(sizes[:traffic["check_window"]]) == want[-1]
        assert all(0 <= o <= traffic["pool_frames"] - s for s, o in zip(sizes, offsets))
    assert lift_driver.plan(traffic, 1) != lift_driver.plan(traffic, 2)


def test_importing_the_video_driver_loads_no_dstformer():
    code = ("import sys\nimport perfbench.drivers.video\n"
            "print(sorted(m for m in sys.modules if 'dstformer' in m))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# the cells at a size the CPU runs in seconds, their limits as the card's
SMALL_CELLS = {
    "perfbench/configs/temporal_lifter.json": {"n_blocks": 2, "clip_len": 12},
    "perfbench/configs/motionbert.json": {k: SMALL[k] for k in
                                          ("hidden", "rep_dim", "n_blocks", "heads", "clip_len")},
    "perfbench/traffic/video.json": {"min_frames": 20, "max_frames": 100, "sizes_per_cycle": 16,
                                     "pool_frames": 256, "check_requests": 4, "check_window": 8,
                                     "trace_seconds": 0.2, "attribution_seconds": 0.2},
}
CELLS = ("temporal.video", "motionbert.video")


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return copy_benchmark(tmp_path_factory.mktemp("bench"), SMALL_CELLS)


def run_small(root, workload, faults=(), traced=False):
    res, _ = core.run(Registry(root), workload, 2 ** 31 + 11, 0.2, traced, "cpu",
                      time.perf_counter(), faults)
    return res


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_video_run_is_correct(small_root, workload):
    res = run_small(small_root, workload, traced=True)
    assert res["correct"], res["checks"]
    assert {"mfu_pct.video", "idle_pct.video", "host_ms.video"} <= set(res["metrics"])


@pytest.mark.parametrize("workload, fault", [(w, f) for w in CELLS for f in faults_video.FAULTS])
def test_each_video_fault_is_not_correct(small_root, workload, fault):
    res = run_small(small_root, workload, (fault,))
    assert not res["correct"], res["checks"]
    assert stblock.temporal_forward_fused.__module__ == stblock.__name__  # put back


@pytest.mark.parametrize("workload", CELLS)
def test_the_video_control_is_not_correct(small_root, workload):
    reg = Registry(small_root)
    cell = reg.workload(workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    for seed in (1, 2):
        c = reg.driver(traffic["driver"]).Cell(cfg, traffic, seed, torch.device("cpu"))
        c.window(0.2)
        c.release()
        gaps = c.control(cell["control"])
        assert any(gaps[k] > limit for k, limit in cell["limits"].items()), gaps


def test_the_temporal_references_clipping_is_lift_sequences():
    """The temporal lifter's plain forward through the reference's video
    clipping equals the module through ``lift_sequence`` (f32)."""
    m = TemporalLifter(clip_len=12, n_blocks=1, hidden=64, heads=4, device="cpu")
    cfg = {"hidden": 64, "n_joints": 17, "clip_len": 12, "n_blocks": 1, "heads": 4,
           "in_dim": 2, "out_dim": 3, "ln_eps": 1e-5}
    kp = keypoints(40, 8)[..., :2]
    want = ref.lift_video(temporal_ref.forward, params(m), torch.from_numpy(kp), cfg)
    np.testing.assert_allclose(lift_sequence(m, kp), want.numpy(), atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_the_published_model_lifts_a_video_on_the_card():
    """At the published widths in bf16: the attention on the kernels, the
    answer within bf16's reach of the f32 reference, its rms gap at most
    1.5x the plain bf16 route's (chip_smoke's F32_ERR_RATIO)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    dev = torch.device("cuda", 0)
    cfg = Registry(REPO).config("motionbert")
    m = DSTformer(device=dev, dtype=torch.bfloat16).init_weights(torch.Generator().manual_seed(9))
    kp = keypoints(600, 9)
    launches = attention.packed_flat_attention.launches, attention.seq_attention.launches
    got = lift_sequence(m, kp)
    assert attention.packed_flat_attention.launches - launches[0] == 10
    assert attention.seq_attention.launches - launches[1] == 10
    with torch.no_grad():
        want = ref.lift_video(ref.forward, {k: v.to(dev) for k, v in params(m).items()},
                              torch.from_numpy(kp).to(dev), cfg).cpu().numpy()
    plain = lift_sequence(m, kp, use_kernels=False)
    rms = {k: float(np.sqrt(((v - want) ** 2).mean())) for k, v in (("kernels", got),
                                                                       ("plain", plain))}
    assert np.abs(got - want).max() < 0.25, np.abs(got - want).max()
    assert rms["kernels"] <= 1.5 * rms["plain"], rms
