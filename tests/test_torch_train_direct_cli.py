"""The direct trainer's CLI and data (``pose3d_tpu_torch/cli/
train_direct.py``, ``data/video_dataset.py``, ``train/epoch.py``,
``config.py``) against the JAX package, on the CPU.

- ``load_video_dataset`` on JPEGs and an ``.npy`` written to a tmpdir
  equals the JAX copy bit for bit (the same cv2 calls);
- ``stack_batches`` equals the JAX function;
- ``train`` for one epoch (ResNet-18, 64 x 64 synthetic frames, bf16
  compute over f32 parameters, the fused route) writes its log and a
  checkpoint that carries the BatchNorm buffers, and ``infer`` restores
  it and reports a finite MPJPE;
- a ``data.data_dir`` that exists but holds no Human3.6M export raises
  FileNotFoundError (the export itself is read in
  ``test_torch_native.py``), and the default device is the card.

The test marked ``cuda`` trains and infers on the card and skips without
one.
"""

import json

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device

from pose3d_tpu_torch.cli import train_direct as cli
from pose3d_tpu_torch.config import DataConfig, DirectConfig, parse_config
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.epoch import stack_batches

torch.set_num_threads(2)


def _video_root(tmp_path, n_frames=5, n_poses=4):
    """A phase-2 pipeline root: n_frames JPEGs (48 x 64, not square) and
    an (n_poses, 17, 3) pseudo-GT ``.npy``."""
    import cv2

    rng = np.random.default_rng(0)
    frames_dir = tmp_path / "ffmpeg_frames" / "clip"
    frames_dir.mkdir(parents=True)
    for i in range(n_frames):
        img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        assert cv2.imwrite(str(frames_dir / f"{i:04d}.jpg"), img)
    (tmp_path / "MB_npy").mkdir()
    np.save(tmp_path / "MB_npy" / "clip.npy", rng.standard_normal((n_poses, 17, 3)))
    return tmp_path


@pytest.mark.parametrize("zero_centre", [True, False])
def test_load_video_dataset_equals_the_jax_copy(tmp_path, zero_centre):
    from pose3d_tpu.data.video_dataset import load_video_dataset as jax_load

    from pose3d_tpu_torch.data.video_dataset import load_video_dataset

    root = _video_root(tmp_path)
    got = load_video_dataset(root, "clip", size=32, zero_centre=zero_centre)
    want = jax_load(root, "clip", size=32, zero_centre=zero_centre)
    assert [a.shape for a in got] == [(4, 17, 2), (4, 17, 3), (4, 32, 32, 3)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if zero_centre:
        assert (got[1][:, 0] == 0).all()


@pytest.mark.parametrize("seed", [None, 3])
def test_stack_batches_equals_the_jax_function(seed):
    from pose3d_tpu.train.epoch import stack_batches as jax_stack

    arrays = (np.arange(23 * 2).reshape(23, 2), np.arange(23))
    rng = (lambda: np.random.default_rng(seed)) if seed is not None else (lambda: None)
    got = stack_batches(arrays, 5, rng())
    want = jax_stack(arrays, 5, rng())
    assert [a.shape for a in got] == [(4, 5, 2), (4, 5)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _cfg(tmp_path, **kw):
    base = {"architecture": "resnet18", "image_size": 64, "batch_size": 4, "chunk_steps": 2,
            "n_epochs": 1, "device": "cpu", "log_dir": str(tmp_path), "run_name": "d",
            "fuse_final_conv": True, "data": DataConfig(synthetic_frames=24)}
    base.update(kw)
    return DirectConfig(**base)


def test_cli_trains_checkpoints_and_infers(tmp_path):
    state = cli.train(_cfg(tmp_path))
    assert state.step == 24 // 8 * 2  # 3 chunks of 2 steps
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    records = [json.loads(line) for line in (tmp_path / "runs" / "d.jsonl").read_text()
               .splitlines()]
    assert records[0]["event"] == "config" and records[-1]["event"] == "finish"
    epoch = records[1]
    assert epoch["epoch"] == 1 and all(np.isfinite(epoch[k]) for k in
                                       ("train_loss", "train_mpjpe", "val_loss", "val_mpjpe"))
    payload = torch.load(tmp_path / "models" / "d", weights_only=True)
    saved = payload["model"]
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved[k], v), k
    assert any(k.endswith("running_var") for k in saved)
    assert saved["deconv_layers.1.num_batches_tracked"] == state.step
    mpjpe = cli.infer(_cfg(tmp_path))
    assert np.isfinite(mpjpe) and mpjpe > 0


def test_cli_resumes(tmp_path):
    first = cli.train(_cfg(tmp_path, fuse_final_conv=False))
    again = cli.train(_cfg(tmp_path, fuse_final_conv=False, n_epochs=0, resume=True))
    assert again.step == first.step
    for k, v in first.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k


def test_video_source_splits_nine_to_one(tmp_path):
    root = _video_root(tmp_path, n_frames=10, n_poses=10)
    cfg = _cfg(tmp_path, source="video", video="clip", pipeline_root=str(root))
    frames, kp3d, stats = cli.load_image_split(cfg, True)
    vframes, vkp3d, _ = cli.load_image_split(cfg, False)
    assert frames.shape == (9, 256, 256, 3) and vframes.shape == (1, 256, 256, 3)
    assert kp3d.shape == (9, 17, 3) and vkp3d.shape == (1, 17, 3) and stats is None
    assert cli._weight_decay(cfg) == 0.0 and cli._weight_decay(_cfg(tmp_path)) == 1e-8
    assert cli._weight_decay(_cfg(tmp_path, weight_decay=0.5)) == 0.5


def test_synthetic_split_matches_the_jax_trainer(tmp_path):
    from pose3d_tpu.cli.train_direct import load_image_split as jax_split
    from pose3d_tpu.config import DataConfig as JaxData
    from pose3d_tpu.config import DirectConfig as JaxConfig

    cfg = _cfg(tmp_path, data=DataConfig(synthetic_frames=40))
    jcfg = JaxConfig(image_size=64, log_dir=str(tmp_path), data=JaxData(synthetic_frames=40))
    for is_train in (True, False):
        got, want = cli.load_image_split(cfg, is_train), jax_split(jcfg, is_train)
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_cli_with_an_existing_data_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="data_3d_h36m_mono.npz"):
        cli.load_image_split(_cfg(tmp_path, data=DataConfig(data_dir=str(tmp_path))), True)


def test_cli_defaults_to_the_card():
    assert parse_config(DirectConfig, []).device == "cuda"
    assert parse_config(DirectConfig, ["--cpu"]).device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass --cpu"):
            cli.train(DirectConfig())


@pytest.mark.cuda
def test_cli_trains_and_infers_on_the_card(tmp_path):
    """One epoch on the fused route on the card (ResNet-18, 64 x 64, bf16
    over f32 parameters): every step launches the conv-decode kernels
    forward and backward, then ``infer`` restores the checkpoint."""
    from pose3d_tpu_torch.ops import conv_decode

    cuda_device()
    before = conv_decode.conv_soft_argmax_3d_backward.launches
    state = cli.train(_cfg(tmp_path, device="cuda"))
    assert conv_decode.conv_soft_argmax_3d_backward.launches - before == state.step == 6
    assert np.isfinite(cli.infer(_cfg(tmp_path, device="cuda")))
