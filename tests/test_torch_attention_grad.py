"""Autograd through the port's attention wrappers
(``pose3d_tpu_torch/ops/attention.py``): their backward against ``jax.vjp``
of the JAX package's ``packed_flat_attention`` / ``seq_attention`` (Pallas
forward in interpret mode, ``custom_vjp`` backward recomputing the XLA
standard-softmax formulation), and, on the card, the module route of
``TemporalLifter(use_kernels=True)`` training its qkv weights as the plain
module does.

Tolerances: f32 gradients within atol 1e-5 + rtol 1e-4 (the same
expression, f32 sums in another order; inputs N(0, 1), gradients below
~|3|). On the card: the qkv weight gradients of the kernel route (bf16
attention kernel forward) against the plain module's (bf16 softmax
attention) within 2^-5 of the gradient's largest element, in relative L2
below 3e-2 (bf16 forwards that round in other places).

The tests marked ``cuda`` skip where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device

from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.ops import attention as A

torch.set_num_threads(2)


def _vjp(fn, qkv, g):
    import jax
    import jax.numpy as jnp

    _, pullback = jax.vjp(fn, jnp.asarray(qkv))
    return np.asarray(pullback(jnp.asarray(g))[0])


def _torch_grad(fn, qkv, g):
    x = torch.from_numpy(qkv).requires_grad_(True)
    fn(x).backward(torch.from_numpy(g))
    return x.grad.numpy()


@pytest.mark.parametrize("seq,n_seqs", [(17, 6), (243, 1)])
def test_packed_backward_matches_jax_vjp(seq, n_seqs):
    from pose3d_tpu.ops.pallas_attention import packed_flat_attention

    rng = np.random.default_rng(seq)
    qkv = rng.standard_normal((n_seqs * seq, 768)).astype(np.float32)
    g = rng.standard_normal((n_seqs * seq, 256)).astype(np.float32)
    want = _vjp(lambda x: packed_flat_attention(x, seq, 8, True), qkv, g)
    got = _torch_grad(lambda x: A.packed_flat_attention(x, seq, 8), qkv, g)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("length,n", [(17, 4), (243, 2)])
def test_seq_backward_matches_jax_vjp(length, n):
    from pose3d_tpu.ops.pallas_attention import seq_attention

    rng = np.random.default_rng(length + 1)
    qkv = rng.standard_normal((n, length, 768)).astype(np.float32)
    g = rng.standard_normal((n, length, 256)).astype(np.float32)
    want = _vjp(lambda x: seq_attention(x, 8, True), qkv, g)
    got = _torch_grad(lambda x: A.seq_attention(x, 8), qkv, g)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_module_route_trains_upstream_of_attention():
    """With use_kernels the qkv weights, LN1 and the embedding get the
    gradients of the plain module (CPU: the wrappers' plain forward, whose
    softmax is the clamped one; the backward is the standard one's)."""
    model = TemporalLifter(clip_len=12, n_blocks=1, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    x = torch.rand(2, 12, 17, 2, generator=torch.Generator().manual_seed(1))
    grads = []
    for use_kernels in (False, True):
        model.zero_grad(set_to_none=True)
        model(x, use_kernels=use_kernels).square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name in ("blocks.0.spatial_attn.qkv.weight", "blocks.0.temporal_attn.qkv.weight",
                 "blocks.0.spatial_norm1.weight", "embed.weight"):
        torch.testing.assert_close(grads[1][name], grads[0][name], atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("clip_len", [40, 100])
def test_kernel_route_trains_qkv_on_the_card(clip_len):
    """Packed (40 frames) and per-sequence (100) attention kernels: the qkv
    weights get the plain module's gradient (before the fix: none)."""
    dev = cuda_device()
    model = TemporalLifter(clip_len=clip_len, n_blocks=1, device="cpu").init_weights(
        torch.Generator().manual_seed(0)).to(dev, torch.bfloat16)
    x = torch.rand(2, clip_len, 17, 2, generator=torch.Generator().manual_seed(1)).to(dev)
    grads = []
    for use_kernels in (False, True):
        model.zero_grad(set_to_none=True)
        model(x, use_kernels=use_kernels).square().mean().backward()
        grads.append({n: p.grad.float() for n, p in model.named_parameters()})
    for name in ("blocks.0.spatial_attn.qkv.weight", "blocks.0.temporal_attn.qkv.weight"):
        got, want = grads[1][name], grads[0][name]
        assert got.abs().max() > 0, name
        assert ((got - want).norm() / want.norm()).item() < 3e-2, name
        assert (got - want).abs().max() <= 2 ** -5 * want.abs().max(), name
