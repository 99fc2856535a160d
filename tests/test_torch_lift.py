"""The port's sequence lifting (``pose3d_tpu_torch/pipeline/lift.py``) and its
keypoint file formats against the JAX package.

The JAX ``lift_sequence`` runs its XLA module route on the CPU. Against
it: the port's module route at f32, 1e-4 (the module's own tolerance);
its fused route on the plain kernels at bf16, 5e-2 against the JAX bf16
apply (the JAX package's fused-vs-apply budget).
"""

import json

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, flax_temporal, torch_temporal

from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.ops import attention as A
from pose3d_tpu_torch.ops import stblock as S
from pose3d_tpu_torch.pipeline import keypoints as K
from pose3d_tpu_torch.pipeline.lift import lift_sequence, lift_video_json

torch.set_num_threads(2)

SMALL = {"clip_len": 27, "hidden": 32, "n_blocks": 1, "heads": 2}


@pytest.fixture(scope="module")
def small():
    _, params = flax_temporal(seed=0, **SMALL)
    return params, torch_temporal(params, **SMALL)


def _kp(n, seed=0):
    return np.random.default_rng(seed).random((n, 17, 2)).astype(np.float32) * 800


def test_module_route_matches_jax(small):
    from pose3d_tpu.models.temporal import TemporalLifter as Flax
    from pose3d_tpu.pipeline.lift import lift_sequence as jax_lift

    params, model = small
    kp = _kp(70)
    want = jax_lift(params, Flax(**SMALL), kp, stride=13)
    got = lift_sequence(model, kp, stride=13)
    assert got.shape == (70, 17, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fused_route_matches_jax_bf16(monkeypatch):
    """A bf16 model of the kernels' widths with full-length clips takes the
    fused forward (here on the plain versions)."""
    import jax.numpy as jnp

    from pose3d_tpu.models.temporal import TemporalLifter as Flax
    from pose3d_tpu.pipeline.lift import lift_sequence as jax_lift

    fields = {"clip_len": 27, "n_blocks": 1}
    _, params = flax_temporal(seed=1, **fields)
    model = torch_temporal(params, dtype=torch.bfloat16, **fields)
    calls, real = [], S.temporal_forward_fused
    monkeypatch.setattr(S, "temporal_forward_fused",
                        lambda m, x: calls.append(tuple(x.shape)) or real(m, x))
    kp = _kp(60, seed=1)
    got = lift_sequence(model, kp)
    assert calls == [(4, 27, 17, 2)]  # starts 0, 13, 26 + the tail anchor 33
    want = jax_lift(params, Flax(dtype=jnp.bfloat16, **fields), kp)
    assert np.abs(got - want).max() < 5e-2


def test_short_video_takes_the_module_route(small, monkeypatch):
    """Under clip_len frames the clips are shorter than the model's, so
    even a model of the kernels' widths runs its module with the
    attention wrappers."""
    model = TemporalLifter(clip_len=27, n_blocks=1, device="cpu", dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    monkeypatch.setattr(S, "temporal_forward_fused", None)  # must not be called
    seen = []
    real = A.packed_flat_attention
    monkeypatch.setattr(A, "packed_flat_attention",
                        lambda qkv, seq, heads: seen.append(seq) or real(qkv, seq, heads))
    out = lift_sequence(model, _kp(20))
    assert out.shape == (20, 17, 3) and np.isfinite(out).all()
    assert seen == [17, 20]  # the spatial, then the temporal half


def test_f32_model_keeps_the_module_without_kernels(small, monkeypatch):
    _, model = small
    monkeypatch.setattr(A, "packed_flat_attention", None)
    monkeypatch.setattr(A, "seq_attention", None)
    kp = _kp(40)
    with torch.no_grad():
        want = model(torch.from_numpy(kp[None, :27] / 1000.0))[0].numpy()
    out = lift_sequence(model, kp, stride=13)
    np.testing.assert_allclose(out[:13], want[:13], atol=1e-5, rtol=0)


def test_tail_is_covered(small):
    """40 frames, clip 27, stride 13: the stride grid ends at frame 39 only
    through the tail anchor; every frame gets a model output."""
    _, model = small
    out = lift_sequence(model, _kp(40), stride=13)
    assert np.abs(out[-5:]).sum() > 0
    assert (np.abs(out).sum(axis=(1, 2)) > 0).all() and np.isfinite(out).all()


def test_empty_input(small):
    _, model = small
    out = lift_sequence(model, np.zeros((0, 17, 2), np.float32))
    assert out.shape == (0, 17, 3) and out.dtype == np.float32


def _write_video_json(path, kp, conf):
    records = [{"image_id": f"{i:04d}.json", "category_id": 1,
                "keypoints": np.concatenate([kp[i], conf[i][:, None]], 1).tolist(),
                "score": float(conf[i].mean())} for i in range(len(kp))]
    path.write_text(json.dumps(records))


def test_lift_video_json_round_trip(small, tmp_path):
    _, model = small
    kp = _kp(30, seed=2)
    conf = np.random.default_rng(3).random((30, 17)).astype(np.float32)
    _write_video_json(tmp_path / "video.json", kp, conf)
    poses = lift_video_json(model, tmp_path / "video.json", tmp_path / "out" / "v.npy")
    np.testing.assert_array_equal(poses, lift_sequence(model, kp))
    np.testing.assert_array_equal(K.load_mb_npy(tmp_path / "out" / "v.npy"), poses)


def test_keypoint_formats_match_jax(tmp_path):
    from pose3d_tpu.pipeline import keypoints as jk

    kp = _kp(12, seed=4)
    conf = np.random.default_rng(5).random((12, 17)).astype(np.float32)
    _write_video_json(tmp_path / "v.json", kp, conf)
    for got, want in zip(K.load_video_json(tmp_path / "v.json"),
                         jk.load_video_json(tmp_path / "v.json")):
        np.testing.assert_array_equal(got, want)
    poses = np.random.default_rng(6).random((12, 17, 3))
    K.save_mb_npy(poses, tmp_path / "a.npy")
    jk.save_mb_npy(poses, tmp_path / "b.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy"))
    np.testing.assert_array_equal(K.load_mb_npy(tmp_path / "a.npy"),
                                  jk.load_mb_npy(tmp_path / "b.npy"))
    np.save(tmp_path / "bad.npy", np.zeros((3, 16, 3)))
    with pytest.raises(ValueError, match="17, 3"):
        K.load_mb_npy(tmp_path / "bad.npy")


@pytest.mark.cuda
class TestLiftOnCard:
    """lift_sequence on the card at full width: each route's launches, and
    the answer against the plain fused path (5e-2) and the f32 module
    (0.1)."""

    @staticmethod
    def _model(dev, dtype=torch.bfloat16):
        model = TemporalLifter(n_blocks=2, device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        return model.to(device=dev, dtype=dtype).eval().requires_grad_(False)

    @pytest.mark.parametrize("frames,spatial,temporal,packed,seq", [
        (300, 2, 2, 0, 0), (100, 0, 0, 2, 2), (40, 0, 0, 4, 0)])
    def test_routes_launch_their_kernels(self, frames, spatial, temporal, packed, seq):
        dev = cuda_device()
        model = self._model(dev)
        kp = _kp(frames, seed=frames)
        counters = (S.spatial_block, S.temporal_slab, A.packed_flat_attention,
                    A.seq_attention)
        before = [f.launches for f in counters]
        out = lift_sequence(model, kp)
        got = [f.launches - b for f, b in zip(counters, before)]
        assert got == [spatial, temporal, packed, seq]
        want32 = lift_sequence(self._model(dev, torch.float32), kp)
        assert np.abs(out - want32).max() < 0.1
