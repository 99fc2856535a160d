"""Video decode, frame extraction and encode: the port of
``pose3d_tpu/pipeline/video.py``.

The reference (``phase2_opp_mb/run.py:113-131`` ``run_ffmpeg``) runs one
ffmpeg process a video to extract fps-resampled frames to
``ffmpeg_frames/<video>/%04d.jpg``. Here the decode runs in the process,
through the port's native decoder (``data/native_video.py``) where it is
built and through cv2 otherwise, with the same frame selection, names and
pixels. cv2 is imported inside the functions that use it, so importing the
pipeline needs no cv2.
"""

from __future__ import annotations

import pathlib

import numpy as np

from pose3d_tpu_torch.data import native_video


def iter_frames(video_path, fps: float | None = None):
    """Yield RGB uint8 frames resampled to ``fps`` (None: the native rate):
    frame i is kept when i reaches the next keep point, which then moves
    on by native_fps / fps frames."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    native_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    step = 1.0 if fps is None else max(native_fps / fps, 1.0)
    next_keep = 0.0
    i = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if i >= next_keep:
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                next_keep += step
            i += 1
    finally:
        cap.release()


def extract_frames(video_path, out_dir, fps: float = 10.0) -> int:
    """Decode a video to ``out_dir/%04d.jpg`` at ``fps`` (the reference's
    1-based names, ``run.py:128``); returns the frame count. The native
    decoder where it is built, else the cv2 loop (the same frames)."""
    if native_video.native_available():
        return native_video.extract_jpegs(video_path, out_dir, fps=fps)
    import cv2

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for frame in iter_frames(video_path, fps):
        n += 1
        cv2.imwrite(str(out / f"{n:04d}.jpg"), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    return n


def run_ffmpeg(videos, raw_dir, frames_dir, reduced_dir=None, fps: float = 10.0):
    """The reference's entry (``run.py:113-131``): extract each video's
    frames under ``frames_dir/<video>/`` and, with ``reduced_dir``, write
    them again as ``<video>_fps.mp4`` there."""
    import cv2

    raw_dir = pathlib.Path(raw_dir)
    for video in videos:
        n = extract_frames(raw_dir / video, pathlib.Path(frames_dir) / video, fps)
        if reduced_dir is not None:
            frames = sorted((pathlib.Path(frames_dir) / video).glob("*.jpg"))
            write_video((cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB) for f in frames),
                        pathlib.Path(reduced_dir) / f"{video}_fps.mp4", fps)
        print(f"extracted {n} frames from {video}")


def write_video(rgb_frames, out_path, fps: float = 10.0) -> int:
    """Encode an iterable of RGB uint8 frames to mp4 (cv2's mp4v encoder, in
    place of the reference's ffmpeg encode, ``run.py:297-299``); returns
    the frame count."""
    import cv2

    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    writer = None
    n = 0
    try:
        for frame in rgb_frames:
            if writer is None:
                h, w = frame.shape[:2]
                writer = cv2.VideoWriter(str(out_path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                         (w, h))
            writer.write(cv2.cvtColor(np.asarray(frame, np.uint8), cv2.COLOR_RGB2BGR))
            n += 1
    finally:
        if writer is not None:
            writer.release()
    return n


def load_frames(frames_dir, size: int | None = None, dtype=np.float32) -> np.ndarray:
    """The ``%04d.jpg`` frames of a directory as one (N, H, W, 3) array,
    resized to ``size`` if given. float32: values in [0, 1), the resize +
    /256 convention of ``H36_dataset.py:129-131``; uint8: the raw pixels,
    normalised on the device (x / 256 of a uint8 is exact in f32, and the
    copy to the card is 4x smaller)."""
    import cv2

    files = sorted(pathlib.Path(frames_dir).glob("*.jpg"))
    frames = []
    for f in files:
        img = cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB)
        if size is not None:
            img = cv2.resize(img, (size, size))
        frames.append(img if dtype == np.uint8 else img.astype(np.float32) / 256.0)
    return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), dtype)
