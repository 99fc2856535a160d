"""Normalisation statistics with the reference's numerics: the port of
``pose3d_tpu/data/stats.py``, in numpy as there.

- The mean sums in the dataset's dtype (float32), ``np.sum(x, 0) / n``.
- The std sums float32 squared deviations into float64, so it comes out
  float64 while the mean stays float32, as in the reference's saved
  ``{mean,std}_train_{2d,3d}.npy``.
- ``max``/``min`` of the 3D statistics are forced to +-1, as the
  reference overrides them.
- A training split computes and saves; an evaluation split loads. The
  files are those of the JAX package (``<stats_dir>/{mean,std}_train_{2d,
  3d}.npy``, ``{max,min}_train_3d.npy``), so a directory written by
  either package loads in the other.

``destandardize`` takes numpy arrays or torch tensors.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch


@dataclasses.dataclass
class NormStats:
    """Per-joint normalisation statistics of one dimensionality."""

    mean: np.ndarray  # (J, D) float32
    std: np.ndarray   # (J, D) float64
    max: np.ndarray | None = None  # (J, 3), +1 (3D only)
    min: np.ndarray | None = None  # (J, 3), -1 (3D only)


def compute_stats(dataset: np.ndarray) -> NormStats:
    """Mean and biased std over the frames of a (N, J, D) array."""
    n_frames, n_joints, dim = dataset.shape
    data_mean = np.sum(dataset, axis=0) / n_frames
    # np.power, not np.square: powf rounds otherwise than x * x in float32,
    # and the reference uses np.power
    sq = np.power(dataset - data_mean, 2)
    data_std = np.sqrt(sq.astype(np.float64).sum(axis=0) / n_frames)
    stats = NormStats(mean=data_mean, std=data_std)
    if dim == 3:
        stats.max = np.ones((n_joints, 3))
        stats.min = -np.ones((n_joints, 3))
    return stats


def _paths(stats_dir, dim: int) -> dict:
    d = pathlib.Path(stats_dir)
    out = {"mean": d / f"mean_train_{dim}d.npy", "std": d / f"std_train_{dim}d.npy"}
    if dim == 3:
        out["max"] = d / "max_train_3d.npy"
        out["min"] = d / "min_train_3d.npy"
    return out


def save_stats(stats: NormStats, stats_dir) -> None:
    dim = stats.mean.shape[-1]
    pathlib.Path(stats_dir).mkdir(parents=True, exist_ok=True)
    for name, path in _paths(stats_dir, dim).items():
        np.save(path, getattr(stats, name))


def load_stats(stats_dir, dim: int) -> NormStats:
    return NormStats(**{name: np.load(path) for name, path in _paths(stats_dir, dim).items()})


def standardize(dataset: np.ndarray, stats: NormStats, normalize: bool = False):
    """2D with ``normalize``: 2x - 1; 3D with ``normalize``: through min/max
    to [0, 1], then -0.5; otherwise (x - mean) / std in the dataset's
    dtype."""
    dim = dataset.shape[-1]
    if normalize:
        if dim == 2:
            return 2.0 * dataset - 1.0
        return (dataset - stats.min) / (stats.max - stats.min) - 0.5
    return ((dataset - stats.mean) / stats.std).astype(dataset.dtype)


def _like(a: np.ndarray, dataset):
    if isinstance(dataset, np.ndarray):
        return a
    return torch.as_tensor(a, dtype=dataset.dtype, device=dataset.device)


def destandardize(dataset, stats: NormStats, normalize: bool = False):
    """The inverse of ``standardize``, on a numpy array or a torch tensor
    (the statistics cast to its dtype and device)."""
    dim = dataset.shape[-1]
    if normalize:
        if dim == 2:
            return (dataset + 1.0) / 2.0
        lo, hi = _like(stats.min, dataset), _like(stats.max, dataset)
        return (dataset + 0.5) * (hi - lo) + lo
    return dataset * _like(stats.std, dataset) + _like(stats.mean, dataset)
