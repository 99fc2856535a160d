"""Typed run configuration: the port of ``DataConfig``, ``LiftConfig``,
``TemporalConfig``, ``DirectConfig``, ``DetectorConfig``, ``LoopConfig``
and ``parse_config`` of ``pose3d_tpu/config.py``.

Each config has every field of the JAX one, with its defaults, plus
``device`` (default ``cuda``; ``--cpu`` sets ``cpu``). ``LoopConfig.resume``
is parsed and unused, as in the JAX trainer.
``TemporalConfig.use_kernels_train`` is JAX's ``use_pallas_train``: train
on the fused sub-block kernels where they apply.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


@dataclasses.dataclass
class DataConfig:
    """The Human3.6M reader's settings (the reference ``H36_dataset.py``
    globals; ``data/h36m.py``)."""

    data_dir: Optional[str] = None   # H36M root (npz/ under it); unset or missing => synthetic
    action: str = ""                 # substring filter, e.g. "Posing"/"Walking"
    zero_centre: bool = True
    standardize_2d: bool = False
    standardize_3d: bool = False
    normalize: bool = False
    num_joints: int = 17
    split_rate: Optional[int] = None
    mono_3d_file: bool = True
    camera_view: bool = True
    all_cameras: bool = False
    synthetic_frames: int = 16384    # synthetic fallback size (train)
    train_subjects: tuple = ("S1", "S5", "S6", "S7", "S8")
    test_subjects: tuple = ("S9", "S11")


@dataclasses.dataclass
class LiftConfig:
    """Phase-1 trainer config (the reference ``train_1.py``)."""

    model: str = "vit"               # vit | martinez | ae
    batch_size: int = 64
    n_epochs: int = 150
    lr: float = 1e-4
    run_name: str = "lift_run"
    resume: bool = False
    flip: bool = False               # validation flip test-time augmentation
    loss: str = "mse"                # mse | l1
    grad_clip: float = 0.0           # global-norm clip (0: none)
    log_dir: str = "./logs"
    seed: int = 0
    ctlc_save: bool = True           # checkpoint on an interrupt
    device: str = "cuda"
    data: DataConfig = dataclasses.field(default_factory=lambda: DataConfig(action="Posing"))


@dataclasses.dataclass
class TemporalConfig:
    """Temporal (MotionBERT-style) sequence lifter config (BASELINE config #3)."""

    clip_len: int = 243
    hidden: int = 256
    n_blocks: int = 5
    heads: int = 8
    batch_size: int = 16
    n_epochs: int = 30
    lr: float = 5e-4
    # fused sub-block kernels for the train step (CUDA, the kernels' widths
    # only; ops/stblock_train): computes in bf16 with f32 parameters
    use_kernels_train: bool = True
    run_name: str = "temporal_run"
    resume: bool = False
    loss: str = "mse"
    log_dir: str = "./logs"
    seed: int = 0
    device: str = "cuda"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


@dataclasses.dataclass
class DirectConfig:
    """Direct image->3D (phase-3/4) trainer config (the reference
    ``train_3.py`` and phase-4 ``train.py``)."""

    architecture: str = "resnet50"
    batch_size: int = 64
    n_epochs: int = 20
    lr: float = 1e-3
    run_name: str = "direct_run"
    resume: bool = False
    z_scale: float = 2.5              # 2.5 phase 3, 2.0 phase 4
    image_size: int = 256             # the reference's input geometry
    source: str = "h36m"              # h36m (phase 3) | video (phase 4)
    video: str = ""                   # phase 4: video name under pipeline_root
    pipeline_root: str = "./videos"   # phase 4: the video pipeline's artifact root
    heatmap_loss_weight: float = 0.0  # optional heatmap MSE supervision
    # the 1x1 conv fused into the decode (ops/conv_decode): coordinates
    # only, so ignored with a heatmap loss
    fuse_final_conv: bool = False
    chunk_steps: int = 8              # optimizer steps per chunk of batches
    loss: str = "mse"
    # None: the reference phase's optimizer, Adam(weight_decay=1e-8) for
    # h36m, bare Adam for video
    weight_decay: Optional[float] = None
    optimizer: str = "adam"
    log_dir: str = "./logs"
    seed: int = 0
    bf16: bool = True
    device: str = "cuda"
    data: DataConfig = dataclasses.field(
        default_factory=lambda: DataConfig(action="1.6", split_rate=50))


@dataclasses.dataclass
class DetectorConfig:
    """2D-detector trainer config (``cli/train_detector.py``): ``PoseNet2D``
    trained on frames rendered on the device from synthetic poses, so that
    the video pipeline's ``--detector posenet2d`` route has trained
    weights."""

    architecture: str = "resnet18"
    batch_size: int = 32
    n_steps: int = 600
    lr: float = 1e-3
    run_name: str = "detector2d"
    resume: bool = False
    image_size: int = 256
    n_train: int = 4096               # synthetic pose pool size
    n_eval: int = 256
    chunk_steps: int = 8              # optimizer steps per chunk
    log_dir: str = "./logs"
    seed: int = 0
    bf16: bool = True
    device: str = "cuda"


@dataclasses.dataclass
class LoopConfig:
    """Phase-5 consistency-loop config (the reference ``train_5.py``)."""

    triangle: bool = False
    triangle_mode: str = "sep"        # sep (TriangleLoss_sep) | cycle (TriangleLoss)
    flip: bool = False
    project: bool = False
    batch_size: int = 64
    n_epochs: int = 20
    lr: float = 5e-4                  # AdamW, one per trained model
    run_name: str = "loop_run"
    lifter_checkpoint: Optional[str] = None     # frozen phase-1 lifter run name
    projector_checkpoint: Optional[str] = None  # frozen projector run name
    resume: bool = False              # parsed, unused (as in the JAX trainer)
    log_dir: str = "./logs"
    seed: int = 0
    bf16: bool = True
    architecture: str = "resnet50"
    image_size: int = 256
    device: str = "cuda"
    data: DataConfig = dataclasses.field(
        default_factory=lambda: DataConfig(action="Walking", split_rate=64))


def _add_fields(parser: argparse.ArgumentParser, cls, prefix=""):
    # every default is None: a flag not passed keeps the dataclass default
    for f in dataclasses.fields(cls):
        if f.name == "data":
            _add_fields(parser, DataConfig, prefix=f"{f.name}.")
            continue
        name = f"--{prefix}{f.name}"
        if f.type in ("bool", bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=None)
        elif f.type in ("int", int, "Optional[int]"):
            parser.add_argument(name, type=int, default=None)
        elif f.type in ("float", float, "Optional[float]"):
            parser.add_argument(name, type=float, default=None)
        elif f.type in ("tuple", tuple):
            parser.add_argument(name, type=lambda s: tuple(s.split(",")), default=None)
        else:
            parser.add_argument(name, type=str, default=None)


def parse_config(cls, argv=None):
    """A config dataclass from flags (``--field value``, ``--data.field
    value``); ``--cpu`` sets ``device`` to ``cpu``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    _add_fields(parser, cls)
    args = vars(parser.parse_args(argv))
    if args.pop("cpu"):
        args["device"] = "cpu"
    data_kwargs = {k.split(".", 1)[1]: v for k, v in args.items()
                   if k.startswith("data.") and v is not None}
    cfg = cls(**{k: v for k, v in args.items() if "." not in k and v is not None})
    if data_kwargs:
        cfg.data = dataclasses.replace(cfg.data, **data_kwargs)
    return cfg
