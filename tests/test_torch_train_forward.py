"""The port's differentiable training forward
(``pose3d_tpu_torch/ops/stblock_train.temporal_train_forward_fused``),
value and gradient, against the JAX package's
(``pallas_stblock_train.temporal_train_forward_fused``, Pallas kernels in
interpret mode) and against the flax ``TemporalLifter`` apply, all in f32
on the CPU, on the same flax-initialised weights
(``temporal_lifter_from_flax``; the JAX gradients are mapped through the
same function, since ``jax.grad`` returns the params' tree).

Tolerances, the JAX suite's own (tests/test_pallas_stblock_train.py:44-81):
outputs atol 2e-4 / rtol 1e-3 (polynomial erf and clamped softmax against
the flax module's exact ones); the MSE loss rtol 1e-5; every parameter's
gradient atol 2e-5 / rtol 2e-3.
"""

import numpy as np
import pytest
import torch

from torch_port_util import flax_temporal, torch_temporal

from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.ops import stblock_train as ST

torch.set_num_threads(2)

FIELDS = {"clip_len": 12, "n_blocks": 2}
CLIPS = 2
PARAMS = [n for n, _ in TemporalLifter(**FIELDS, device="cpu").named_parameters()]


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.ops import pallas_stblock_train as st
    from pose3d_tpu_torch.interop.weights import temporal_lifter_from_flax

    fmodel, params = flax_temporal(seed=0, **FIELDS)
    rng = np.random.default_rng(0)
    x = rng.random((CLIPS, 12, 17, 2)).astype(np.float32)
    y = rng.random((CLIPS, 12, 17, 3)).astype(np.float32)

    def loss_jax(p):
        out = st.temporal_train_forward_fused(p, jnp.asarray(x), interpret=True, **FIELDS)
        return jnp.mean((out - y) ** 2), out

    def loss_flax(p):
        out = fmodel.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.mean((out - y) ** 2), out

    results = {}
    for name, fn in (("jax", loss_jax), ("flax", jax.jit(loss_flax))):
        (loss, out), grads = jax.value_and_grad(fn, has_aux=True)(params)
        grads = temporal_lifter_from_flax(jax.tree.map(np.asarray, grads))
        results[name] = (float(loss), np.asarray(out), {k: v.numpy() for k, v in grads.items()})

    model = torch_temporal(params, **FIELDS)
    out = ST.temporal_train_forward_fused(model, torch.from_numpy(x))
    loss = (out - torch.from_numpy(y)).square().mean()
    loss.backward()
    results["port"] = (loss.item(), out.detach().numpy(),
                       {n: p.grad.numpy() for n, p in model.named_parameters()})
    return results


@pytest.mark.parametrize("ref", ["jax", "flax"])
def test_value(setup, ref):
    np.testing.assert_allclose(setup["port"][1], setup[ref][1], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(setup["port"][0], setup[ref][0], rtol=1e-5)


@pytest.mark.parametrize("name", PARAMS)
@pytest.mark.parametrize("ref", ["jax", "flax"])
def test_param_grad(setup, ref, name):
    np.testing.assert_allclose(setup["port"][2][name], setup[ref][2][name],
                               atol=2e-5, rtol=2e-3)


def test_every_param_gets_a_gradient(setup):
    grads = setup["port"][2]
    assert sorted(grads) == sorted(PARAMS)
    assert all(np.abs(g).max() > 0 for g in grads.values())
