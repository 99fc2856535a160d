"""pose3d_tpu_torch: the PyTorch/CUDA port of ``pose3d_tpu``.

The JAX package stays the reference; this package computes the same
functions with PyTorch on an NVIDIA Hopper GPU, and every Pallas kernel on
a ported path becomes a CUDA kernel written by hand for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use and bound through ``ctypes``.

Ported so far: the lifter serving path (all three lifter families), the
temporal serving path, temporal training, the direct image->3D forward
and training, the phase-1 lifter trainer with the Human3.6M keypoint
reader and the predict CLI, the video pipeline, the phase-5 trainers,
the SMPL-IK family with the renders, and data and tensor parallelism.

- ``models/lifters.py``  ``MartinezLifter``, ``AELifter``,
  ``JointTransformerLifter`` (the reference LinearModel, AE, MyViT).
- ``models/temporal.py`` ``TemporalLifter``, ``clip_starts``, ``make_clips``;
  ``models/dstformer.py`` ``DSTformer`` (MotionBERT's dual-stream lifter).
- ``models/resnet.py``, ``models/heads.py``  ``ResNet``, ``PoseNet3D`` (the
  reference Model_3D); ``models/norm.py`` the f32 BatchNorms.
- ``interop/weights.py`` flax param trees -> the port's state dicts.
- ``ops/``               kernel wrappers + plain versions: the ViT trunk
  (``lifter.py``), the Martinez block (``martinez.py``), the temporal
  sub-blocks (``stblock.py``) and their training forms
  (``stblock_train.py``), attention (``attention.py``), the direct
  model's decodes, forward and backward (``softargmax.py``,
  ``conv_decode.py``; the plain ones and the heatmap targets in
  ``heatmap.py``).
- ``losses.py``, ``train/``, ``core/``, ``data/``, ``config.py``,
  ``cli/train_lift.py``, ``cli/train_temporal.py``, ``cli/train_direct.py``
  the three trainers and what they need (the lifter epochs in
  ``train/epoch.py``, the direct model's steps in ``train/image_steps.py``,
  the Human3.6M reader in ``data/h36m.py``, the pose transforms in
  ``core/transforms.py``).
- ``models/smpl.py``, ``models/hybrik.py``, ``models/smpl_pose.py`` the
  SMPL body, HybrIK inverse kinematics, ``PoseSMPLNet`` and
  ``HybrIKPose``; ``train/smpl_steps.py`` its train step;
  ``core/affine.py`` the crop geometry.
- ``utils/visualize.py`` the renders (matplotlib, imported inside).
- ``cli/predict.py``     2D keypoints -> 3D with a trained checkpoint.
- ``pipeline/lift.py``   ``lift_sequence``: video -> 3D.
- ``serving.py``         ``LifterService``: bucketed batch inference.
- ``parallel/mesh.py``   the (data, model) mesh on ``torch.distributed``:
  the shards, the flat collectives, the model axis' gather (the DP steps
  live in ``train/``, global BatchNorm in ``models/norm.py``);
  ``parallel/sharding.py`` tensor parallelism of the Martinez and AE
  lifters; ``parallel/dryrun.py`` the multi-process dry run.

The package imports torch and numpy, never jax, flax or ``pose3d_tpu``.
"""

__version__ = "0.1.0"
