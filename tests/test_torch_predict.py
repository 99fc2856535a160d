"""The port's inference CLI (``pose3d_tpu_torch/cli/predict.py``) against
the JAX package's (``pose3d_tpu/cli/predict.py`` on the CPU), on the same
weights: the JAX side reads an orbax checkpoint that its own
``checkpoint.save`` wrote, the port's side the port's ``torch.save``
checkpoint of the same weights.

Routes: ``vit``, ``martinez`` and ``ae`` at the lifters' default widths
(the widths both CLIs build), with seeded biases, BN scales and
statistics, on 50 frames in chunks of 16 (three whole chunks and a
padded one); ``temporal`` (hidden 64, 1 block, 4 heads, clips of 12,
the head count read from the checkpoint's ``.meta.json``) on a
30-frame video JSON. Limit: atol 1e-4 in f32 (PERF.md §2: f32 sums in
another order). The port's temporal route equals ``lift_sequence`` on
the checkpoint's f32 module bitwise.
"""

import json

import numpy as np
import pytest
import torch

from torch_port_util import (_seeded_norms, flax_bn_lifter, flax_temporal, flax_vit,
                             torch_bn_lifter, torch_temporal, torch_vit)

from pose3d_tpu_torch.cli import predict
from pose3d_tpu_torch.pipeline.lift import lift_sequence
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.state import create_train_state

torch.set_num_threads(2)

TEMPORAL = {"clip_len": 12, "hidden": 64, "n_blocks": 1, "heads": 4}


def _save_both(tmp_path, kind, with_jax=True):
    """Seeded weights of ``kind`` saved as a port checkpoint named "run"
    under tmp_path/port and, ``with_jax``, as a JAX one under
    tmp_path/jax; returns the port's module."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train import checkpoint as jax_ckpt
    from pose3d_tpu.train.state import create_train_state as jax_state

    if kind == "vit":
        fmodel, params = flax_vit(seed=0)
        params, stats = _seeded_norms(params, np.random.default_rng(1), False), {}
        model = torch_vit(params)
        example, extra = jnp.zeros((1, 17, 2)), {}
    elif kind == "temporal":
        fmodel, params = flax_temporal(seed=0, **TEMPORAL)
        params, stats = _seeded_norms(params, np.random.default_rng(1), False), {}
        model = torch_temporal(params, **TEMPORAL)
        example = jnp.zeros((1, TEMPORAL["clip_len"], 17, 2))
        extra = {"heads": TEMPORAL["heads"]}
    else:
        fmodel, params, stats = flax_bn_lifter(kind, seed=0)
        model = torch_bn_lifter(kind, params, stats)
        example, extra = jnp.zeros((1, 17, 2)), {}
    if with_jax:
        js = jax_state(fmodel, jax.random.key(0), example, lr=1e-3)
        js = js.replace(params=jax.tree.map(jnp.asarray, params),
                        batch_stats=jax.tree.map(jnp.asarray, stats) if stats else js.batch_stats)
        jax_ckpt.save(js, tmp_path / "jax", "run", extra=extra)
    ckpt.save(create_train_state(model, lr=1e-3), tmp_path / "port", "run", extra=extra)
    return model


def _run(tmp_path, which, kind, inp, *extra):
    from pose3d_tpu.cli import predict as jax_predict

    out = tmp_path / f"{which}.npy"
    argv = ["--model", kind, "--checkpoint", "run", "--log_dir", str(tmp_path / which),
            "--input", str(inp), "--output", str(out), "--cpu", *extra]
    (jax_predict if which == "jax" else predict).main(argv)
    return np.load(out)


@pytest.mark.parametrize("kind", ["vit", "martinez", "ae"])
def test_frame_routes_match_jax(tmp_path, kind):
    _save_both(tmp_path, kind)
    kp = np.random.default_rng(2).random((50, 17, 2)).astype(np.float32)
    np.save(tmp_path / "kp.npy", kp)
    want = _run(tmp_path, "jax", kind, tmp_path / "kp.npy", "--batch_size", "16")
    got = _run(tmp_path, "port", kind, tmp_path / "kp.npy", "--batch_size", "16")
    assert got.shape == want.shape == (50, 17, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(want).max() > 0.1  # the outputs are not near zero


def _video_json(path, n, seed):
    kp = np.random.default_rng(seed).random((n, 17, 3)) * [900.0, 900.0, 1.0]
    path.write_text(json.dumps([{"image_id": f"{i:04d}.jpg", "category_id": 1,
                                 "keypoints": kp[i].tolist(), "score": 0.9}
                                for i in range(n)]))
    return kp[..., :2].astype(np.float32)


def test_temporal_route_matches_jax_and_lift_sequence(tmp_path):
    model = _save_both(tmp_path, "temporal")
    px = _video_json(tmp_path / "video.json", 30, seed=3)
    want = _run(tmp_path, "jax", "temporal", tmp_path / "video.json", "--image_size", "900")
    got = _run(tmp_path, "port", "temporal", tmp_path / "video.json", "--image_size", "900")
    assert got.shape == want.shape == (30, 17, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    direct = lift_sequence(model, (px / 900.0) * 900.0, image_size=900.0)
    np.testing.assert_array_equal(got, direct)


def test_temporal_architecture_comes_from_the_checkpoint(tmp_path):
    """Widths from the state dict's shapes, heads from the sidecar, and
    ``--heads`` over both."""
    _save_both(tmp_path, "temporal", with_jax=False)
    model = predict.temporal_from_checkpoint(tmp_path / "port", "run", device="cpu")
    assert (model.hidden, model.n_blocks, model.clip_len, model.heads) == (64, 1, 12, 4)
    assert not model.training and model.dtype == torch.float32
    assert predict.temporal_from_checkpoint(tmp_path / "port", "run", 8, device="cpu").heads == 8


def test_last_chunk_is_padded_only_after_a_whole_one(tmp_path):
    """The frame route's outputs do not depend on the chunking: one chunk
    shorter than the batch (no pad), and whole chunks plus a padded one."""
    _save_both(tmp_path, "martinez", with_jax=False)
    kp = np.random.default_rng(4).random((10, 17, 2)).astype(np.float32)
    np.save(tmp_path / "kp.npy", kp)
    one = _run(tmp_path, "port", "martinez", tmp_path / "kp.npy", "--batch_size", "64")
    padded = _run(tmp_path, "port", "martinez", tmp_path / "kp.npy", "--batch_size", "4")
    np.testing.assert_allclose(padded, one, atol=1e-5, rtol=0)


def test_bad_input_shape_and_missing_cuda_raise(tmp_path):
    _save_both(tmp_path, "ae", with_jax=False)
    np.save(tmp_path / "bad.npy", np.zeros((5, 16, 2), np.float32))
    with pytest.raises(ValueError, match="expected"):
        _run(tmp_path, "port", "ae", tmp_path / "bad.npy")
    if not torch.cuda.is_available():
        np.save(tmp_path / "kp.npy", np.zeros((5, 17, 2), np.float32))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            predict.main(["--model", "ae", "--checkpoint", "run", "--log_dir",
                          str(tmp_path / "port"), "--input", str(tmp_path / "kp.npy"),
                          "--output", str(tmp_path / "o.npy")])
