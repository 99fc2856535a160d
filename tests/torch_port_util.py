"""Shared set-up of the port's tests (``tests/test_torch_*.py``).

The port's tests feed one set of seeded numpy inputs and weights to the
JAX package and to ``pose3d_tpu_torch`` and compare the outputs. JAX is
imported only inside the helpers that need it, so the files that hold
the tests which need a GPU also import where JAX is absent (run them
there with ``--noconftest``; ``tests/conftest.py`` imports JAX).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


def flax_vit(seed: int = 0, **fields):
    """(flax JointTransformerLifter, its params as numpy) at ``fields``."""
    jax = pytest.importorskip("jax")
    from pose3d_tpu.models.lifters import JointTransformerLifter

    model = JointTransformerLifter(**fields)
    x = np.zeros((1, fields.get("n_joints", 17), fields.get("in_dim", 2)),
                 np.float32)
    params = model.init({"params": jax.random.key(seed)}, x, train=False)["params"]
    return model, jax.tree.map(np.asarray, params)


def torch_vit(params, dtype=torch.float32, device="cpu", **fields):
    """The port's JointTransformerLifter at ``fields``, holding ``params``."""
    from pose3d_tpu_torch.interop.weights import vit_lifter_from_flax
    from pose3d_tpu_torch.models.lifters import JointTransformerLifter

    model = JointTransformerLifter(**fields, device=device, dtype=dtype)
    model.load_state_dict(vit_lifter_from_flax(params), strict=True)
    return model.eval()


def cuda_device() -> torch.device:
    """The first CUDA device; skips the calling test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)
