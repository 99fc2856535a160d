"""Skeleton renders and loss curves (matplotlib): the port of
``pose3d_tpu/utils/visualize.py`` (the reference ``utils.py:35-110``
``visualize_3d`` / ``visualize_2d``, :344-367 ``plot_losses``, the phase-2
render loop ``run.py:219-267`` and the phase-5 dispatcher
``visualize.py:11-43``): the ground truth in turquoise, predictions in
violet-red, the 17-bone Human3.6M skeleton, fixed [-1, 1] 3D axes seen
from elev=120, azim=60.

matplotlib (on the Agg backend) is imported inside each function, and
cv2 inside those that read or resize frames, so that importing the port
needs neither (the GPU host has no matplotlib). Each function takes numpy
arrays or tensors (a tensor goes through ``.cpu().numpy()``) and draws
what the JAX function draws on the same values: the files are the same,
byte for byte, with the same matplotlib and cv2.
"""

from __future__ import annotations

import io
import pathlib

import numpy as np

from pose3d_tpu_torch.core.skeleton import BONES

GT_POINT, GT_BONE = "turquoise", "darkturquoise"
PRED_POINT, PRED_BONE = "mediumvioletred", "palevioletred"


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x, dtype=None) -> np.ndarray:
    """A tensor (detached, on the host) or an array-like, as numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _pad_root(kp, dim):
    if kp.shape[0] != 17:
        kp = np.concatenate([np.zeros((1, dim), kp.dtype), kp], axis=0)
    return kp


def _figure_rgb(plt, fig) -> np.ndarray:
    """A figure as an RGB uint8 frame, through a PNG in memory (the JAX
    function's path, so the frames are its frames); closes the figure."""
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    buf.seek(0)
    arr = plt.imread(buf)
    return (arr[..., :3] * 255).astype(np.uint8)


def visualize_3d(gt, pred, path):
    """Ground truth against prediction, 3D skeletons (utils.py:35-79)."""
    plt = _pyplot()
    gt, pred = _pad_root(_np(gt), 3), _pad_root(_np(pred), 3)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    for kp, pc, bc, label in ((gt, GT_POINT, GT_BONE, "gt"),
                              (pred, PRED_POINT, PRED_BONE, "pred")):
        x, y, z = kp.T
        ax.scatter(x, y, z, color=pc, label=label)
        for a, b in BONES:
            ax.plot([x[a], x[b]], [y[a], y[b]], [z[a], z[b]], color=bc)
    ax.legend(loc="upper left")
    ax.set_xlim(-1, 1), ax.set_ylim(-1, 1), ax.set_zlim(-1, 1)
    ax.set_xticks([-1, 0, 1]), ax.set_yticks([-1, 0, 1]), ax.set_zticks([-1, 0, 1])
    ax.set_xlabel("X"), ax.set_ylabel("Y"), ax.set_zlabel("Z")
    ax.grid(False)
    ax.view_init(elev=120, azim=60)
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def visualize_2d(gt, pred=None, frame=None, path="kp.png", scale=1000.0):
    """2D keypoints over a frame (utils.py:81-110): coordinates in [0, 1]
    scaled by 1000 onto a 1000^2 resize of the frame."""
    plt = _pyplot()
    gt = _pad_root(_np(gt, np.float64), 2) * scale
    fig = plt.figure()
    if frame is not None:
        import cv2

        plt.imshow(cv2.resize(_np(frame), (int(scale), int(scale)),
                              interpolation=cv2.INTER_CUBIC))
    plt.plot(gt[:, 0], gt[:, 1], "o", color=GT_POINT, markersize=3)
    for a, b in BONES:
        plt.plot(gt[[a, b], 0], gt[[a, b], 1], color=GT_BONE)
    if pred is not None:
        pred = _pad_root(_np(pred, np.float64), 2) * scale
        plt.plot(pred[:, 0], pred[:, 1], "o", color=PRED_POINT, markersize=3)
        for a, b in BONES:
            plt.plot(pred[[a, b], 0], pred[[a, b], 1], color=PRED_BONE)
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def visualize_3d_heatmap(heatmap, path="3d.png", threshold=1e-4):
    """The voxels above ``threshold`` of a (J, D, H, W) volume, scattered
    (utils.py:8-32)."""
    plt = _pyplot()
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    hm = _np(heatmap)
    for j in range(hm.shape[0]):
        idx = np.argwhere(hm[j] > threshold)
        if len(idx):
            ax.scatter(idx[:, 0], idx[:, 1], idx[:, 2], s=10,
                       c=hm[j][tuple(idx.T)] * 10, marker="o", alpha=0.5)
    ax.set_xlim(0, hm.shape[1]), ax.set_ylim(0, hm.shape[2]), ax.set_zlim(0, hm.shape[3])
    ax.set_xlabel("X"), ax.set_ylabel("Y"), ax.set_zlabel("Z")
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def plot_losses(train_losses, val_losses, train_metric, val_metric, out_prefix):
    """Loss and MPJPE curves, ``<out_prefix>/plot_metric.pdf``
    (utils.py:344-367)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(20, 6))
    plt.subplot(1, 2, 1)
    plt.plot(_np(train_losses), color=GT_BONE)
    plt.plot(_np(val_losses), color=PRED_BONE)
    plt.xlabel("epoch"), plt.ylabel("Loss")
    plt.legend(["training", "validation"])
    plt.subplot(1, 2, 2)
    plt.plot(_np(train_metric), color=GT_BONE)
    plt.plot(_np(val_metric), color=PRED_BONE)
    plt.xlabel("epoch"), plt.ylabel("MPJPE")
    plt.legend(["training", "validation"])
    out = pathlib.Path(f"{out_prefix}/plot_metric.pdf")
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out)
    plt.close(fig)


def render_2d_video(json_path, frames_dir, out_mp4, fps: float = 10.0) -> int:
    """The merged detections over their frames -> an mp4 (run.py:271-303),
    rendered in memory; returns the frame count."""
    import cv2

    from pose3d_tpu_torch.pipeline.keypoints import load_video_json
    from pose3d_tpu_torch.pipeline.video import write_video

    plt = _pyplot()
    kp2d, _, _ = load_video_json(json_path)
    files = sorted(pathlib.Path(frames_dir).glob("*.jpg"))

    def frames():
        for kp, f in zip(kp2d, files):
            img = cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB)
            fig = plt.figure()
            plt.imshow(img)
            for a, b in BONES:
                plt.plot(kp[[a, b], 0], kp[[a, b], 1], "y")
            plt.plot(kp[:, 0], kp[:, 1], "ob", markersize=4)
            yield _figure_rgb(plt, fig)

    return write_video(frames(), out_mp4, fps)


def render_3d_video(poses, out_mp4, fps: float = 10.0, scale: float = 1.0,
                    to_global: bool = False, subject: str = "S1", camera: int = 2) -> int:
    """A (T, 17, 3) sequence -> an mp4 of skeletons (run.py:305-352);
    returns the frame count.

    ``to_global`` is the reference's MotionBERT display convention: the
    camera -> global rotation of the subject's camera quaternion
    (run.py:312-316); the reference then scales by 2.8 (:343): pass
    ``scale=2.8`` for it.
    """
    from pose3d_tpu_torch.pipeline.keypoints import rotate_to_global
    from pose3d_tpu_torch.pipeline.video import write_video

    plt = _pyplot()
    poses = _np(poses)
    if to_global:
        poses = rotate_to_global(poses, subject=subject, camera=camera)

    def frames():
        for pose in poses * scale:
            fig = plt.figure()
            ax = fig.add_subplot(projection="3d")
            x, y, z = pose.T
            ax.scatter(x, y, z, color=PRED_POINT)
            for a, b in BONES:
                ax.plot([x[a], x[b]], [y[a], y[b]], [z[a], z[b]], color=PRED_BONE)
            ax.set_xlim(-1, 1), ax.set_ylim(-1, 1), ax.set_zlim(-1, 1)
            yield _figure_rgb(plt, fig)

    return write_video(frames(), out_mp4, fps)
