"""2D keypoint detectors: the port of ``pose3d_tpu/pipeline/detector.py``.

The reference runs ``python3 -m openpifpaf.predict`` once a frame
(``run.py:134-166``), and each run loads the model again. Here a
detector takes a whole directory of frames in one call and writes one
``<frame>.predictions.json`` a frame: a list of people, each
``{"keypoints": [x, y, confidence] * 17 flat, "score", ...}``, the layout
OpenPifPaf writes and ``keypoints.save_to_json`` reads.

- ``OpenPifPafDetector``: one OpenPifPaf process for all the frames of a
  directory, with the reference's flags; COCO joint order.
- ``PoseNet2DDetector``: the ``PoseNet2D`` model on its device (the card
  unless it was built on the CPU), in batches; H36M joint order, so its
  JSON is merged with ``already_h36m=True``.
- ``MockDetector``: seeded plausible COCO detections for tests, the JAX
  package's draws from the same seed.
"""

from __future__ import annotations

import json
import pathlib
import subprocess

import numpy as np
import torch

from pose3d_tpu_torch.pipeline.video import load_frames


class Detector2D:
    """Frames -> per-frame person detections (17 joints)."""

    def detect_dir(self, frames_dir, out_json_dir) -> None:
        """Write one ``<frame>.predictions.json`` for each ``*.jpg`` frame of
        ``frames_dir`` under ``out_json_dir``."""
        raise NotImplementedError


class OpenPifPafDetector(Detector2D):
    checkpoint = "shufflenetv2k30"
    instance_threshold = 0.2

    def detect_dir(self, frames_dir, out_json_dir) -> None:
        out = pathlib.Path(out_json_dir)
        out.mkdir(parents=True, exist_ok=True)
        frames = sorted(str(p) for p in pathlib.Path(frames_dir).glob("*.jpg"))
        # one process for the whole directory, where the reference runs one a frame
        cmd = [
            "python3", "-m", "openpifpaf.predict", *frames,
            "--checkpoint", self.checkpoint,
            "--force-complete-pose",
            "--instance-threshold", str(self.instance_threshold),
            "--json-output", str(out),
        ]
        subprocess.run(cmd, check=True)


class MockDetector(Detector2D):
    """Deterministic plausible COCO detections (for tests and fixtures)."""

    def __init__(self, seed: int = 0, n_people: int = 1):
        self.seed = seed
        self.n_people = n_people

    def detect_dir(self, frames_dir, out_json_dir) -> None:
        out = pathlib.Path(out_json_dir)
        out.mkdir(parents=True, exist_ok=True)
        rng = np.random.default_rng(self.seed)
        for f in sorted(pathlib.Path(frames_dir).glob("*.jpg")):
            people = []
            for _ in range(self.n_people):
                kp = np.zeros((17, 3))
                kp[:, 0] = rng.uniform(100, 900, 17)
                kp[:, 1] = rng.uniform(100, 900, 17)
                kp[:, 2] = rng.uniform(0.5, 1.0, 17)
                people.append({
                    "keypoints": kp.flatten().tolist(),
                    "bbox": [100.0, 100.0, 800.0, 800.0],
                    "score": float(rng.uniform(0.3, 0.99)),
                    "category_id": 1,
                })
            with open(out / f"{f.name}.predictions.json", "w") as fh:
                json.dump(people, fh)


class PoseNet2DDetector(Detector2D):
    """Batched ``PoseNet2D`` inference on the model's device; keypoints in
    H36M order (merge them with ``already_h36m=True``).

    ``model``: a ``PoseNet2D`` in eval mode on its device, in the dtype it
    computes in (the checkpoint's: bf16 where it was trained so, else f32).
    """

    max_inflight = 6  # chunks enqueued before the oldest is read back

    def __init__(self, model, image_size: int = 256, batch_size: int = 64):
        self.model = model
        self.image_size = image_size
        self.batch_size = batch_size

    def detect_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        """(N, S, S, 3) uint8 frames -> (N, 17, 2) f32 coordinates in [0, 1].

        Chunks of ``batch_size`` frames go from pinned host buffers (on a
        card) to the device by non-blocking copies, are divided by 256 there
        (``H36_dataset.py:131``: x / 256 of a uint8 is exact in f32) and run
        through the model; the last chunk is padded with zero frames. At
        most ``max_inflight`` chunks are in flight: once the window is full
        the oldest result is read back (which waits for the work enqueued
        before the read), and its host buffer serves the chunk that comes
        ``max_inflight`` later.
        """
        if frames_u8.dtype != np.uint8:
            raise ValueError(f"frames are {frames_u8.dtype}, not uint8")
        n, bs = len(frames_u8), self.batch_size
        if n == 0:
            return np.zeros((0, 17, 2), np.float32)
        device = next(self.model.parameters()).device
        pin = device.type == "cuda"
        buffers = [torch.empty((bs, *frames_u8.shape[1:]), dtype=torch.uint8, pin_memory=pin)
                   for _ in range(min(self.max_inflight, -(-n // bs)))]
        pending, preds = [], []
        with torch.inference_mode():
            for k, s in enumerate(range(0, n, bs)):
                chunk = frames_u8[s:s + bs]
                buf = buffers[k % len(buffers)]
                buf[:len(chunk)] = torch.from_numpy(np.ascontiguousarray(chunk))
                buf[len(chunk):] = 0
                x = buf.to(device, non_blocking=True).to(torch.float32) / 256.0
                pending.append((len(chunk), self.model(x)))
                if len(pending) >= self.max_inflight:
                    m, coords = pending.pop(0)
                    preds.append(coords[:m].cpu().numpy())
            preds += [coords[:m].cpu().numpy() for m, coords in pending]
        return np.concatenate(preds).reshape(-1, 17, 2)

    def detect_dir(self, frames_dir, out_json_dir) -> None:
        files = sorted(pathlib.Path(frames_dir).glob("*.jpg"))
        frames = load_frames(frames_dir, size=self.image_size, dtype=np.uint8)
        write_predictions(files, self.detect_frames(frames), out_json_dir)


def write_predictions(files, coords: np.ndarray, out_json_dir) -> None:
    """One ``<file name>.predictions.json`` a frame under ``out_json_dir``:
    one person whose (17, 2) coordinates in [0, 1] are scaled to the
    reference's 1000-pixel frame, with confidence 1 and score 1.0."""
    out = pathlib.Path(out_json_dir)
    out.mkdir(parents=True, exist_ok=True)
    for f, kp in zip(files, np.asarray(coords, np.float32) * 1000.0):
        person = {
            "keypoints": np.concatenate([kp, np.ones((17, 1))], axis=1).flatten().tolist(),
            "score": 1.0,
            "category_id": 1,
        }
        with open(out / f"{pathlib.Path(f).name}.predictions.json", "w") as fh:
            json.dump([person], fh)
