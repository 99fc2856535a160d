"""Shared set-up of the port's tests (``tests/test_torch_*.py``).

The port's tests feed one set of seeded numpy inputs and weights to the
JAX package and to ``pose3d_tpu_torch`` and compare the outputs. JAX is
imported only inside the helpers that need it, so the files that hold
the tests which need a GPU also import where JAX is absent (run them
there with ``--noconftest``; ``tests/conftest.py`` imports JAX).
"""

from __future__ import annotations

import functools

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


def flax_temporal(seed: int = 0, **fields):
    """(flax TemporalLifter, its params as numpy) at ``fields``."""
    jax = pytest.importorskip("jax")
    from pose3d_tpu.models.temporal import TemporalLifter

    model = TemporalLifter(**fields)
    x = np.zeros((1, fields.get("clip_len", 243), fields.get("n_joints", 17),
                  fields.get("in_dim", 2)), np.float32)
    # jitted: one compile instead of an eager dispatch per op (~5x faster)
    params = jax.jit(model.init)({"params": jax.random.key(seed)}, x)["params"]
    return model, jax.tree.map(np.asarray, params)


@functools.cache
def _jitted_apply(model):
    import jax

    return jax.jit(lambda params, x: model.apply({"params": params}, x))


def flax_apply(model, params, x) -> np.ndarray:
    """``model.apply`` under one jit per flax module (modules hash by
    their fields), as numpy."""
    return np.asarray(_jitted_apply(model)(params, x))


def torch_temporal(params, dtype=torch.float32, device="cpu", **fields):
    """The port's TemporalLifter at ``fields``, holding ``params``."""
    from pose3d_tpu_torch.interop.weights import temporal_lifter_from_flax
    from pose3d_tpu_torch.models.temporal import TemporalLifter

    model = TemporalLifter(**fields, device=device, dtype=dtype)
    model.load_state_dict(temporal_lifter_from_flax(params), strict=True)
    return model.eval()


def cuda_device() -> torch.device:
    """The first CUDA device; skips the calling test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)
