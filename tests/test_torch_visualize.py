"""The port's renders (``pose3d_tpu_torch/utils/visualize.py``) against the
JAX package's (``pose3d_tpu/utils/visualize.py``), on the CPU: each
function's PNG, PDF or mp4 on the same numpy input equals the JAX
function's byte for byte (the same matplotlib and cv2 write both; the PDF
with ``SOURCE_DATE_EPOCH`` fixed, as it carries its creation date). A
tensor input gives the file of its numpy values. The mp4s have one frame
an input pose or frame.
"""

import json

import numpy as np
import pytest
import torch

from pose3d_tpu_torch.pipeline.video import iter_frames
from pose3d_tpu_torch.utils import visualize as tv


def _poses(n, seed):
    return (0.4 * np.random.default_rng(seed).standard_normal((n, 17, 3))).astype(np.float32)


def _same_bytes(a, b):
    assert a.exists() and a.stat().st_size > 0
    assert a.read_bytes() == b.read_bytes(), (a, b)


@pytest.mark.parametrize("joints", [17, 16], ids=["17", "root_padded"])
def test_visualize_3d_equals_jax(tmp_path, joints):
    from pose3d_tpu.utils import visualize as jv

    gt, pred = _poses(2, 1)[:, 17 - joints:]
    tv.visualize_3d(gt, pred, tmp_path / "port" / "a.png")
    jv.visualize_3d(gt, pred, tmp_path / "jax" / "a.png")
    _same_bytes(tmp_path / "port" / "a.png", tmp_path / "jax" / "a.png")
    tv.visualize_3d(torch.from_numpy(gt), torch.from_numpy(pred), tmp_path / "t.png")
    _same_bytes(tmp_path / "t.png", tmp_path / "jax" / "a.png")


@pytest.mark.parametrize("case", ["frame_and_pred", "gt_only"])
def test_visualize_2d_equals_jax(tmp_path, case):
    from pose3d_tpu.utils import visualize as jv

    rng = np.random.default_rng(2)
    gt, pred = rng.random((2, 17, 2))
    frame = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    kw = {"pred": pred, "frame": frame} if case == "frame_and_pred" else {}
    tv.visualize_2d(gt, path=tmp_path / "port.png", **kw)
    jv.visualize_2d(gt, path=tmp_path / "jax.png", **kw)
    _same_bytes(tmp_path / "port.png", tmp_path / "jax.png")
    if kw:
        kw = {"pred": torch.from_numpy(pred), "frame": torch.from_numpy(frame)}
        tv.visualize_2d(torch.from_numpy(gt), path=tmp_path / "t.png", **kw)
        _same_bytes(tmp_path / "t.png", tmp_path / "jax.png")


def test_visualize_3d_heatmap_equals_jax(tmp_path):
    from pose3d_tpu.utils import visualize as jv

    hm = np.random.default_rng(3).random((3, 8, 8, 8)).astype(np.float32) ** 8
    tv.visualize_3d_heatmap(hm, tmp_path / "port.png", threshold=0.2)
    jv.visualize_3d_heatmap(hm, tmp_path / "jax.png", threshold=0.2)
    _same_bytes(tmp_path / "port.png", tmp_path / "jax.png")


def test_plot_losses_equals_jax(tmp_path, monkeypatch):
    from pose3d_tpu.utils import visualize as jv

    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    curves = [list(np.random.default_rng(4 + i).random(6)) for i in range(4)]
    tv.plot_losses(*curves, tmp_path / "port")
    jv.plot_losses(*curves, tmp_path / "jax")
    _same_bytes(tmp_path / "port" / "plot_metric.pdf", tmp_path / "jax" / "plot_metric.pdf")


def _frames_and_json(tmp_path, n=4):
    """n JPEG frames and a consolidated video JSON of keypoints in pixels."""
    import cv2

    rng = np.random.default_rng(5)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(n):
        cv2.imwrite(str(frames / f"{i + 1:04d}.jpg"),
                    rng.integers(0, 256, (60, 80, 3), dtype=np.uint8))
    kp = np.concatenate([rng.uniform(0, 80, (n, 17, 2)), np.ones((n, 17, 1))], -1)
    records = [{"image_id": f"{i + 1:04d}.jpg", "keypoints": kp[i].tolist(), "score": 1.0}
               for i in range(n)]
    path = tmp_path / "video.json"
    path.write_text(json.dumps(records))
    return frames, path


def test_render_2d_video_equals_jax(tmp_path):
    from pose3d_tpu.utils import visualize as jv

    frames, js = _frames_and_json(tmp_path)
    n = tv.render_2d_video(js, frames, tmp_path / "port.mp4", fps=5.0)
    assert n == jv.render_2d_video(js, frames, tmp_path / "jax.mp4", fps=5.0) == 4
    _same_bytes(tmp_path / "port.mp4", tmp_path / "jax.mp4")
    assert len(list(iter_frames(tmp_path / "port.mp4"))) == 4


@pytest.mark.parametrize("to_global", [False, True], ids=["camera", "global"])
def test_render_3d_video_equals_jax(tmp_path, to_global):
    """The camera frame, and the reference's display convention (the S1
    camera-2 rotation, x2.8)."""
    from pose3d_tpu.utils import visualize as jv

    poses = _poses(3, 6)
    kw = {"scale": 2.8, "to_global": True} if to_global else {}
    n = tv.render_3d_video(poses, tmp_path / "port.mp4", fps=5.0, **kw)
    assert n == jv.render_3d_video(poses, tmp_path / "jax.mp4", fps=5.0, **kw) == 3
    _same_bytes(tmp_path / "port.mp4", tmp_path / "jax.mp4")
    tv.render_3d_video(torch.from_numpy(poses), tmp_path / "t.mp4", fps=5.0, **kw)
    _same_bytes(tmp_path / "t.mp4", tmp_path / "jax.mp4")
    assert len(list(iter_frames(tmp_path / "port.mp4"))) == 3
