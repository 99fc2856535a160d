"""The port's 2D detector (``pose3d_tpu_torch/models/heads.py``
``PoseNet2D``, ``interop/weights.py`` ``posenet2d_from_flax``,
``pipeline/detector.py`` ``PoseNet2DDetector``) against the JAX package,
on the CPU.

The flax ``PoseNet2D`` (ResNet-18, 17 joints) is initialised once, with
seeded biases, BN scales and BN statistics, and its final 1x1 conv scaled
by 256 (``torch_port_util.flax_posenet2d``): a fresh init gives every
coordinate within ~2e-3 of 0.47 on 64 x 64 frames, which would make a
comparison vacuous, so each test asserts a coordinate spread (std over
frames and joints) of at least 0.1. Frames are 64 x 64. Tolerances:

- the bridge vs the JAX package's ``posenet2d_to_torch``: bitwise;
- the f32 ``PoseNet2D`` vs the flax apply, B = 2: coordinates atol 1e-4
  (PoseNet3D's limit, PERF.md §2: f32 convolutions summed in another
  order);
- the bf16 model vs the flax f32 apply: atol 5e-2 (the bf16 budget); its
  largest error against the port's f32 model at most 1.5x the JAX bf16
  model's against the flax f32 one, on 8 frames (the f32 yardstick of
  PERF.md §2: the error is bf16's own, not the port's);
- ``detect_frames`` (chunks of 4, the last padded, a window of 2 chunks in
  flight) vs the module on all frames in one batch: atol 1e-5 (f32
  convolutions of other batch sizes);
- ``detect_dir`` (12 frames, ``image_size=64``, ``batch_size=4``) vs the
  JAX ``PoseNet2DDetector`` on the same frames: keypoints atol 0.1 px
  (1e-4 x 1000), the rest of each JSON equal.

The test marked ``cuda`` runs ``detect_frames`` on the card against the
CPU and skips without one.
"""

import json
import types

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, flax_apply, flax_posenet2d, torch_posenet2d

from pose3d_tpu_torch.data.synthetic import render_pose_frames, synthetic_h36m
from pose3d_tpu_torch.interop.weights import posenet2d_from_flax
from pose3d_tpu_torch.models.heads import PoseNet2D
from pose3d_tpu_torch.pipeline.detector import PoseNet2DDetector

torch.set_num_threads(2)

F32_ATOL = 1e-4
BF16_ATOL = 5e-2
BF16_OWN_RATIO = 1.5  # the port's bf16 error over JAX's, on the same weights
MIN_SPREAD = 0.1


def _frames_u8(n, size=64, seed=1):
    """Rendered skeleton frames with noise, as uint8: what a camera gives."""
    kp, _ = synthetic_h36m(n, seed=seed)
    frames = render_pose_frames(kp, torch.Generator().manual_seed(seed), size=size)
    return (frames.numpy() * 255.0).astype(np.uint8)


def _flax_model():
    from pose3d_tpu.models.heads import PoseNet2D as FlaxPoseNet2D

    return FlaxPoseNet2D(architecture="resnet18")


def test_bridge_equals_the_jax_package_export():
    from pose3d_tpu.interop.torch_weights import posenet2d_to_torch

    params, stats = flax_posenet2d()
    got = posenet2d_from_flax(params, stats)
    want = posenet2d_to_torch({"params": params, "batch_stats": stats})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = PoseNet2D("resnet18", device="cpu")
    assert set(model.state_dict()) == set(got)
    assert model.final_layer.weight.shape == (17, 256, 1, 1)
    assert model.preact.conv1.weight.is_contiguous(memory_format=torch.channels_last)


def test_f32_matches_flax():
    params, stats = flax_posenet2d()
    x = _frames_u8(2).astype(np.float32) / 256.0
    want = flax_apply(_flax_model(), params, x, stats)
    got = torch_posenet2d(params, stats, architecture="resnet18")(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 34) and got.dtype == torch.float32
    assert want.std() >= MIN_SPREAD, want.std()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=F32_ATOL, rtol=0)
    assert 0.0 <= want.min() and want.max() < 1.0


def test_bf16_matches_flax_f32():
    params, stats = flax_posenet2d()
    x = _frames_u8(2).astype(np.float32) / 256.0
    want = flax_apply(_flax_model(), params, x, stats)
    model = torch_posenet2d(params, stats, torch.bfloat16, architecture="resnet18")
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and model.preact.bn1.weight.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0)


def test_bf16_error_is_bf16s_own():
    """The port's bf16 detector lies from its f32 model at most 1.5x as far
    as the JAX package's bf16 ``PoseNet2D`` lies from its own f32 model, on
    the same weights and frames: the distance is bf16's, not the port's."""
    import jax.numpy as jnp

    from pose3d_tpu.models.heads import PoseNet2D as FlaxPoseNet2D

    params, stats = flax_posenet2d()
    x = _frames_u8(8, seed=3).astype(np.float32) / 256.0
    jax32 = flax_apply(_flax_model(), params, x, stats)
    jax16 = flax_apply(FlaxPoseNet2D(architecture="resnet18", dtype=jnp.bfloat16), params, x,
                       stats).astype(np.float32)
    with torch.inference_mode():
        port32, port16 = (torch_posenet2d(params, stats, dtype, architecture="resnet18")(
            torch.from_numpy(x)).numpy() for dtype in (torch.float32, torch.bfloat16))
    assert jax32.std() >= MIN_SPREAD
    e_port, e_jax = np.abs(port16 - port32).max(), np.abs(jax16 - jax32).max()
    assert 0 < e_port <= BF16_OWN_RATIO * e_jax, (e_port, e_jax)


def test_detect_frames_chunks_pad_and_window():
    params, stats = flax_posenet2d()
    model = torch_posenet2d(params, stats, architecture="resnet18")
    frames = _frames_u8(10, seed=3)
    det = PoseNet2DDetector(model, image_size=64, batch_size=4)
    det.max_inflight = 2  # 3 chunks: the window fills and drains
    got = det.detect_frames(frames)
    with torch.inference_mode():
        want = model(torch.from_numpy(frames).float() / 256.0).numpy().reshape(-1, 17, 2)
    assert got.shape == (10, 17, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got.std() >= MIN_SPREAD
    assert det.detect_frames(frames[:0]).shape == (0, 17, 2)
    with pytest.raises(ValueError, match="uint8"):
        det.detect_frames(frames.astype(np.float32) / 256.0)


def test_detect_dir_matches_jax(tmp_path):
    """12 frames as JPEGs, batch 4 and 64 x 64 on both sides."""
    cv2 = pytest.importorskip("cv2")

    from pose3d_tpu.pipeline.detector import PoseNet2DDetector as JaxDetector

    frames = tmp_path / "frames"
    frames.mkdir()
    for i, f in enumerate(_frames_u8(12, size=96, seed=4)):
        cv2.imwrite(str(frames / f"{i + 1:04d}.jpg"), cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    params, stats = flax_posenet2d()
    state = types.SimpleNamespace(apply_fn=_flax_model().apply, params=params,
                                  batch_stats=stats)
    JaxDetector(state, image_size=64, batch_size=4).detect_dir(frames, tmp_path / "jax")
    PoseNet2DDetector(torch_posenet2d(params, stats, architecture="resnet18"), image_size=64,
                      batch_size=4).detect_dir(frames, tmp_path / "port")
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.json"))
    assert len(names) == 12 and names == sorted(p.name for p in (tmp_path / "port").glob("*"))
    kp_got, kp_want = [], []
    for n in names:
        (got,), (want,) = (json.loads((tmp_path / d / n).read_text()) for d in ("port", "jax"))
        assert {k: v for k, v in got.items() if k != "keypoints"} == \
            {k: v for k, v in want.items() if k != "keypoints"} == {"score": 1.0,
                                                                      "category_id": 1}
        kp_got.append(got["keypoints"])
        kp_want.append(want["keypoints"])
    kp_got, kp_want = np.asarray(kp_got).reshape(12, 17, 3), np.asarray(kp_want).reshape(12, 17, 3)
    assert (kp_got[..., 2] == 1.0).all()
    assert (kp_want[..., :2] / 1000.0).std() >= MIN_SPREAD
    np.testing.assert_allclose(kp_got, kp_want, atol=0.1, rtol=0)


@pytest.mark.cuda
def test_detect_frames_on_the_card_matches_the_cpu():
    """f32 on the card with TF32 off vs the CPU: atol 1e-3 (1 px at the
    x1000 scale; cuDNN convolutions sum in other orders)."""
    device = cuda_device()
    model = PoseNet2D("resnet18", device="cpu").init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.final_layer.weight.mul_(256.0)
    frames = _frames_u8(10, seed=5)
    want = PoseNet2DDetector(model.eval(), image_size=64, batch_size=4).detect_frames(frames)
    got = PoseNet2DDetector(model.to(device), image_size=64, batch_size=4).detect_frames(frames)
    assert want.std() >= MIN_SPREAD
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
