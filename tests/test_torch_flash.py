"""Flash attention in the port (``pose3d_tpu_torch/ops/flash_attention.py``,
kernels 14a-14c of ``csrc/flash_attention.cu``) and the temporal lifter's
long-clip options (``flash``, ``remat``), on the CPU against the JAX
package and, marked ``cuda``, on the card against the plain versions.

On the CPU, in f32:

- the plain version (``flash_attention_reference``, and the autograd
  Function's forward and backward, which run the plain versions on a CPU
  tensor) against JAX's ``_MHSA(flash=True)``, whose attention on the CPU
  is its einsum branch (the Pallas TPU kernel has no interpret mode), and
  against the port's standard attention (``ops.attention.
  standard_attention``); its gradients against ``jax.vjp`` of the same
  function. L in {17, 243, 256, 300} and Lq != Lk. Limits: atol 1e-5 +
  rtol 1e-4 (PERF.md §2's attention-backward row: f32 sums in another
  order; inputs N(0, 1)).
- ``TemporalLifter(flash=True)``, ``(remat=True)`` and both against
  flax's module with the same flags (the forward within the training
  forward's limits, atol 1e-4 + rtol 1e-4; the loss's parameter
  gradients within atol 1e-5 + rtol 1e-3 of ``jax.grad``'s), and
  ``remat`` bitwise the module's own values and gradients.
- ``interop.weights.temporal_lifter_from_flax`` on a ``remat=True`` flax
  tree (blocks named ``CheckpointSpatioTemporalBlock_i``), and its error on
  a tree with no blocks.

On the card (bf16): each kernel against its plain version on the same
inputs, the backward kernels on the forward kernel's O and log-sum-exp (O within 2^-6 + 2^-7 |want|; dQ, dK, dV within 2^-7 max|want| +
2^-7 |want|; the log-sum-exp within 2^-12 (1 + |want|); each output's
error against a float64 run at most 1.5x the plain version's + 2^-16 of
the largest float64 value), two calls bitwise equal, one launch a call;
14c launched before 14b, its D = rowsum(dO ∘ O) within 2^-18 of the
row's Σ|dO ∘ O| of ``flash_delta`` on the same O and dO (f32 sums of f32
products in another order); the Function's backward runs no PyTorch op
for D; f32 raises TypeError. On the CPU, ``flash_backward_dq`` writes
``flash_delta``'s D bitwise and ``flash_backward_reference``'s dQ; and
the three kernels are ``wgmma`` on a TMA ring (their source).
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device

from pose3d_tpu_torch.ops import flash_attention as F

torch.set_num_threads(2)

O_ATOL, O_RTOL = 2 ** -6, 2 ** -7
GRAD_REL = 2 ** -7
LSE_TOL = 2 ** -12
DELTA_REL = 2 ** -18  # of the row's Σ|dO ∘ O|
F64_RATIO = 1.5

# (sequences, Lq, Lk, heads, dh, separate kv rows)
CARD_SHAPES = [(4, 17, 17, 8, 32, False), (16 * 17, 243, 243, 8, 32, False),
               (2, 256, 256, 4, 64, False), (3, 300, 300, 16, 16, False),
               (3, 100, 300, 8, 32, True), (3, 300, 65, 4, 64, True),
               (8, 2048, 2048, 8, 32, False),
               (2, 129, 129, 8, 32, False),  # 14b: a partial 128-key work tile
               (2, 1, 300, 4, 64, True),     # one query row: one partial query tile
               (3, 64, 17, 16, 16, True)]    # 14b's second warpgroup holds no valid key


def _card_inputs(n, lq, lk, heads, dh, separate, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    dim = heads * dh
    qkv = torch.randn(n, lq, 3 * dim, generator=g).to(dev, torch.bfloat16)
    kv = torch.randn(n, lk, 2 * dim, generator=g).to(dev, torch.bfloat16) if separate else None
    dout = torch.randn(n, lq, dim, generator=g).to(dev, torch.bfloat16)
    return qkv, kv, dout


def _run(qkv, kv, dout, heads, kernel: bool, saved=None):
    """(O, lse, dQ, dK, dV, D) from the kernels, 14c (dQ and D) before 14b,
    or from the plain versions on the same device: the backward on
    ``saved``, the kernels' (O, lse), where given, so that each kernel
    meets its plain version on the same inputs, else on the plain
    forward's (on float64 inputs: the float64 yardstick)."""
    q, k, v = F._views(qkv, kv)
    if kernel:
        o, lse = F.flash_forward(q, k, v, heads)
        delta = torch.empty_like(lse)
        dq = F._views(torch.empty_like(qkv), None)[0]  # the strides of the sources
        dk, dv = F._views(torch.empty_like(qkv), None if kv is None else torch.empty_like(kv))[1:]
        F.flash_backward_dq(q, k, v, dout, o, lse, heads, dq, delta)
        F.flash_backward_dkv(q, k, v, dout, lse, delta, heads, dk, dv)
        return o, lse, dq, dk, dv, delta
    o, lse = F.flash_forward_reference(q, k, v, heads)
    bo, blse = (o, lse) if saved is None else saved
    delta = F.flash_delta(dout, bo, heads)
    return (o, lse, *F.flash_backward_reference(q, k, v, dout, blse, delta, heads), delta)


def _hold(name, got, want, ref64, atol, rtol):
    got, want, ref64 = got.double(), want.double(), ref64.double()
    bad = (got - want).abs() > atol + rtol * want.abs()
    assert not bad.any(), (name, (got - want).abs().max().item())
    err, plain = ((t - ref64).abs().max().item() for t in (got, want))
    assert err <= F64_RATIO * plain + 2 ** -16 * ref64.abs().max().item(), (name, err, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s[:5]))
                         + ("-kv" if s[5] else ""))
def test_kernels_match_plain_on_card(shape):
    dev = cuda_device()
    n, lq, lk, heads, dh, separate = shape
    qkv, kv, dout = _card_inputs(*shape, dev)
    counts = [f.launches for f in (F.flash_forward, F.flash_backward_dkv, F.flash_backward_dq)]
    got = _run(qkv, kv, dout, heads, kernel=True)
    again = _run(qkv, kv, dout, heads, kernel=True)
    torch.cuda.synchronize()
    assert [f.launches for f in (F.flash_forward, F.flash_backward_dkv,
                                 F.flash_backward_dq)] == [c + 2 for c in counts]
    want = _run(qkv, kv, dout, heads, kernel=False, saved=got[:2])
    ref64 = _run(qkv.double(), None if kv is None else kv.double(), dout.double(), heads,
                 kernel=False)
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv", "delta"), got, again):
        assert torch.equal(a, b), f"{name} differs between two calls"
        assert torch.isfinite(a).all(), name
    _hold("o", got[0], want[0], ref64[0], O_ATOL, O_RTOL)
    torch.testing.assert_close(got[1], want[1], atol=LSE_TOL, rtol=LSE_TOL)
    for name, g, w, r in zip(("dq", "dk", "dv"), got[2:5], want[2:5], ref64[2:5]):
        _hold(name, g, w, r, GRAD_REL * w.abs().max().item(), GRAD_REL)
    # D: 14c's against flash_delta on the kernel's O and the same dO
    scale = F.flash_delta(dout.abs(), got[0].abs(), heads)
    assert ((got[5] - want[5]).abs() <= DELTA_REL * scale).all(), \
        (got[5] - want[5]).abs().max().item()


@pytest.mark.cuda
def test_autograd_function_on_card():
    """The Function's gradient of qkv (and kv) on the kernels against the
    plain versions' on the same device, and the zero k/v columns of qkv's
    gradient where kv is given."""
    dev = cuda_device()
    for separate in (False, True):
        qkv, kv, dout = _card_inputs(3, 243, 300 if separate else 243, 8, 32, separate, dev)
        grads = []
        for forward in (F.flash_attention, F.flash_attention_reference):
            ins = tuple(t.clone().requires_grad_(True) for t in (qkv, kv) if t is not None)
            grads.append(torch.autograd.grad(forward(ins[0], 8, *ins[1:]), ins, dout))
        for g, w in zip(*grads):
            assert (g.float() - w.float()).abs().max() <= 2 * GRAD_REL * w.float().abs().max()
        if separate:
            assert not grads[0][0][..., 256:].any()


@pytest.mark.cuda
def test_function_backward_runs_no_delta_op_on_card(monkeypatch):
    """On the card the Function's backward launches 14c, then 14b, and
    computes D with no PyTorch op: ``flash_delta`` is never called. Its
    backward is the first work on the autograd engine's thread here (the
    case where an encoder without a current context refused the maps)."""
    dev = cuda_device()
    qkv, _, dout = _card_inputs(2, 300, 300, 8, 32, False, dev)
    real, order = F._build.library(), []

    class Recorder:  # the library, noting the order of the flash launchers
        def __getattr__(self, name):
            fn = getattr(real, name)
            if not name.startswith("flash_"):
                return fn
            return lambda *args: (order.append(name), fn(*args))[1]

    def refuse(*args, **kwargs):
        raise AssertionError("flash_delta ran on the card")

    monkeypatch.setattr(F._build, "library", Recorder)
    monkeypatch.setattr(F, "flash_delta", refuse)
    x = qkv.clone().requires_grad_(True)
    grad = torch.autograd.grad(F.flash_attention(x, 8), x, dout)[0]
    torch.cuda.synchronize()
    assert order == ["flash_fwd_launch", "flash_bwd_dq_launch", "flash_bwd_dkv_launch"]
    assert torch.isfinite(grad).all()


@pytest.mark.cuda
def test_kernels_refuse_f32_on_card():
    dev = cuda_device()
    qkv = torch.zeros(2, 17, 3 * 64, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        F.flash_attention(qkv, 2)
    with pytest.raises(ValueError, match="head width"):
        F.flash_attention(qkv.bfloat16(), 8)  # dh = 8


# --- the CPU: the plain versions against JAX ------------------------------------

F32_ATOL, F32_RTOL = 1e-5, 1e-4
FWD_ATOL, FWD_RTOL = 2e-4, 1e-3   # the training forward's limits (test_torch_train_forward.py)
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-3
DIM, HEADS = 64, 4


def _flax_mhsa(seed: int, length: int, n: int = 2):
    """(flax ``_MHSA(flash=True)``, its params as numpy, an input)."""
    import jax

    from pose3d_tpu.models.temporal import _MHSA

    mod = _MHSA(DIM, HEADS, flash=True)
    x = np.random.default_rng(seed).standard_normal((n, length, DIM)).astype(np.float32)
    params = jax.jit(mod.init)(jax.random.key(seed), x)["params"]
    return mod, jax.tree.map(np.asarray, params), x


def _port_mhsa(params, flash=True):
    from pose3d_tpu_torch.interop.weights import _dense
    from pose3d_tpu_torch.models.temporal import _MHSA

    sd = {}
    _dense(params["Dense_0"], "qkv", sd)
    _dense(params["Dense_1"], "proj", sd)
    mod = _MHSA(DIM, HEADS, flash=flash, device="cpu")
    mod.load_state_dict(sd, strict=True)
    return mod


@pytest.mark.parametrize("length", [17, 243, 256, 300])
def test_flash_mhsa_matches_jax(length):
    """The port's ``_MHSA(flash=True)`` (the Function on the plain
    versions) against flax's on the CPU (its einsum branch): the output,
    and the gradients of x and of both projections against ``jax.vjp``."""
    import jax
    import jax.numpy as jnp

    mod, params, x = _flax_mhsa(length, length)
    g = np.random.default_rng(length + 1).standard_normal(x.shape).astype(np.float32)
    want, pullback = jax.vjp(lambda p, xx: mod.apply({"params": p}, xx),
                             jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    dparams, dx = jax.tree.map(np.asarray, pullback(jnp.asarray(g)))
    port = _port_mhsa(params)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=F32_ATOL,
                               rtol=F32_RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), dx, atol=F32_ATOL, rtol=F32_RTOL)
    for name, key in (("qkv", "Dense_0"), ("proj", "Dense_1")):
        lin = getattr(port, name)
        np.testing.assert_allclose(lin.weight.grad.numpy(), dparams[key]["kernel"].T,
                                   atol=F32_ATOL, rtol=F32_RTOL, err_msg=name)
        np.testing.assert_allclose(lin.bias.grad.numpy(), dparams[key]["bias"],
                                   atol=F32_ATOL, rtol=F32_RTOL, err_msg=name)


@pytest.mark.parametrize("length", [17, 243, 300])
def test_flash_matches_standard_attention(length):
    """``flash_attention`` (forward and qkv gradient) against the port's
    standard-softmax attention on the same qkv rows."""
    from pose3d_tpu_torch.ops.attention import standard_attention

    rng = np.random.default_rng(length)
    qkv = rng.standard_normal((3, length, 3 * DIM)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((3, length, DIM)).astype(np.float32))
    outs = []
    for fn in (F.flash_attention, standard_attention):
        x = torch.from_numpy(qkv).requires_grad_(True)
        y = fn(x, HEADS)
        outs.append((y.detach(), torch.autograd.grad(y, x, g)[0]))
    np.testing.assert_allclose(F.flash_attention_reference(torch.from_numpy(qkv), HEADS),
                               outs[0][0], atol=0, rtol=0)
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=F32_ATOL, rtol=F32_RTOL)


def _jax_cross_attention(qkv, kv, heads):
    """The einsum branch of JAX's ``_MHSA`` with k and v from ``kv``."""
    import jax.numpy as jnp
    from jax import nn as jnn

    n, lq, three = qkv.shape
    dim, lk = three // 3, kv.shape[1]
    d = dim // heads
    q = qkv[..., :dim].reshape(n, lq, heads, d).transpose(0, 2, 1, 3)
    k = kv[..., :dim].reshape(n, lk, heads, d).transpose(0, 2, 1, 3)
    v = kv[..., dim:].reshape(n, lk, heads, d).transpose(0, 2, 1, 3)
    a = jnn.softmax(jnp.einsum("nhld,nhmd->nhlm", q, k) * d ** -0.5, axis=-1)
    return jnp.einsum("nhlm,nhmd->nhld", a, v).transpose(0, 2, 1, 3).reshape(n, lq, dim)


@pytest.mark.parametrize("lq,lk", [(17, 243), (300, 65), (128, 256), (1, 129), (65, 17)])
def test_cross_lengths_match_jax(lq, lk):
    """Lq != Lk (the sequence-parallel form: local queries over gathered
    keys and values): the output and both gradients against ``jax.vjp``;
    the k and v columns of qkv get a zero gradient. (1, 129) and (65, 17)
    are the lengths at 14b's edges: one query row against a partial
    128-key work tile, and a second query tile against keys that fill
    less than one warpgroup's 64."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(lq * lk)
    qkv = rng.standard_normal((2, lq, 3 * DIM)).astype(np.float32)
    kv = rng.standard_normal((2, lk, 2 * DIM)).astype(np.float32)
    g = rng.standard_normal((2, lq, DIM)).astype(np.float32)
    want, pullback = jax.vjp(lambda a, b: _jax_cross_attention(a, b, HEADS), jnp.asarray(qkv),
                             jnp.asarray(kv))
    dqkv, dkv = (np.asarray(t) for t in pullback(jnp.asarray(g)))
    x, y = (torch.from_numpy(a).requires_grad_(True) for a in (qkv, kv))
    got = F.flash_attention(x, HEADS, y)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=F32_ATOL,
                               rtol=F32_RTOL)
    np.testing.assert_allclose(x.grad.numpy(), dqkv, atol=F32_ATOL, rtol=F32_RTOL)
    np.testing.assert_allclose(y.grad.numpy(), dkv, atol=F32_ATOL, rtol=F32_RTOL)
    assert not x.grad[..., DIM:].any()


@pytest.mark.parametrize("lq,lk", [(17, 17), (100, 300), (300, 65)])
def test_backward_dq_writes_delta_on_cpu(lq, lk):
    """On the CPU ``flash_backward_dq`` writes D bitwise ``flash_delta``'s
    and dQ bitwise ``flash_backward_reference``'s on that D, into a dQ
    view with q's strides, and ``flash_backward_dkv`` reads that D."""
    rng = np.random.default_rng(lq + lk)
    qkv = torch.from_numpy(rng.standard_normal((2, lq, 3 * DIM)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, lk, 2 * DIM)).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((2, lq, DIM)).astype(np.float32))
    q, k, v = F._views(qkv, kv)
    o, lse = F.flash_forward(q, k, v, HEADS)
    delta = torch.full_like(lse, float("nan"))
    dq = F._views(torch.full_like(qkv, float("nan")), None)[0]
    F.flash_backward_dq(q, k, v, dout, o, lse, HEADS, dq, delta)
    want_delta = F.flash_delta(dout, o, HEADS)
    assert torch.equal(delta, want_delta)
    want = F.flash_backward_reference(q, k, v, dout, lse, want_delta, HEADS)
    assert torch.equal(dq, want[0]) and dq.stride() == q.stride()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    F.flash_backward_dkv(q, k, v, dout, lse, delta, HEADS, dk, dv)
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])


def test_flash_kernels_are_wgmma_on_a_tma_ring():
    """Kernels 14a and 14c issue wgmma on K and V tiles that TMA brings
    into an mbarrier ring, and 14b on Q and dO tiles: no mma.sync,
    ldmatrix or cp.async is left in any of them, 14b owns its keys (no
    atomics), and the source note says what bounds them and what the
    design does. The head-tile products, descriptors and maps come from
    attention_sm90.cuh, which the source includes."""
    from pathlib import Path

    csrc = Path(F.__file__).parent.parent / "csrc"
    src = (csrc / "flash_attention.cu").read_text()
    head = (csrc / "attention_sm90.cuh").read_text()
    assert '#include "attention_sm90.cuh"' in src
    rule = "// " + "-" * 48
    engine = src[src.index(f"{rule} the query-major"):src.index(f"{rule} 14b: the key-major")]
    dkv = src[src.index(f"{rule} 14b: the key-major"):src.index(f"{rule} host")]
    for kernel in ("flash_fwd_kernel(const __grid_constant__ CUtensorMap",
                   "flash_dq_kernel(const __grid_constant__ CUtensorMap"):
        assert kernel in engine, kernel
    assert "flash_dkv_kernel(const __grid_constant__ CUtensorMap" in dkv
    for section in (engine, dkv):  # 14b's lse and D slices come by copy4_async, not tiles
        for old in ("mma_bf16(", "ldsm_x4", "cp_async", "__syncthreads();\n    float s", "atomic"):
            assert old not in section, old
    for new in ("wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16",
                "rowtile::wgmma_m64n128<0, 0>(", "rowtile::wgmma_m64n64<0, 0>("):
        assert new in head, new
    for new in ("issue_scores<DH, kN>(", "issue_rows<DH, kN>(", "rt::tma_load3(",
                "ring.acquire()", "ring.claim(", "rt::regs_dec", "rt::regs_inc", "row_dot<DH>"):
        assert new in engine, new
    for new in ("issue_scores<DH, kN>(s, k_a, qd)", "issue_scores<DH, kN>(dp, v_a,",
                "issue_rows<DH, kN>(dva, p,", "issue_rows<DH, kN>(dka, ds, qd)",
                "rt::tma_load3(", "ring.acquire()", "slots.claim(", "expect_bytes(full,",
                "copies_arrive(full)",
                "ring.release(ring.next - 2)", "rt::regs_dec", "rt::regs_inc"):
        assert new in dkv, new
    assert "CU_TENSOR_MAP_SWIZZLE_64B" in head and "CU_TENSOR_MAP_SWIZZLE_32B" in head
    assert "head_box_map<DH>(" in src
    assert "mma_bf16(" not in src + head and "ldsm_x4" not in src + head
    note = " ".join(line.removeprefix("//").strip()
                    for line in src[:src.index("#include")].splitlines())
    for phrase in ("What bounds them on this card", "0.27 ms", "wgmma", "TMA", "mbarrier",
                   "transpose flag", "D = rowsum(dO * O)", "14c launches first", "no atomics",
                   "key-major", "4 Lq bytes apart"):
        assert phrase in note, phrase


def test_wrapper_refuses_bad_shapes():
    with pytest.raises(ValueError, match="3 x dim"):
        F.flash_attention(torch.zeros(2, 5, 100), 4)
    with pytest.raises(ValueError, match="kv must be"):
        F.flash_attention(torch.zeros(2, 5, 3 * DIM), HEADS, torch.zeros(2, 5, DIM))


# --- the lifter's long-clip options ------------------------------------------------

LIFTER = {"clip_len": 20, "hidden": 64, "n_blocks": 2, "heads": 4}
FLAGS = {"flash": {"flash": True}, "remat": {"remat": True},
         "flash_remat": {"flash": True, "remat": True}}


def _lifter_inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, LIFTER["clip_len"], 17, 2)).astype(np.float32)
    y = rng.standard_normal((2, LIFTER["clip_len"], 17, 3)).astype(np.float32)
    return x, y


def _port_loss_grads(model, x, y):
    model.zero_grad(set_to_none=True)
    pred = model(torch.from_numpy(x))
    loss = (pred - torch.from_numpy(y)).square().mean()
    loss.backward()
    return pred.detach(), loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
def test_lifter_options_match_flax(flags):
    """``TemporalLifter`` with the flags against flax's with the same
    flags: the prediction, the MSE loss and every parameter's gradient."""
    import jax
    import jax.numpy as jnp

    from torch_port_util import flax_temporal

    from pose3d_tpu_torch.interop.weights import temporal_lifter_from_flax
    from pose3d_tpu_torch.models.temporal import TemporalLifter

    fmodel, params = flax_temporal(seed=3, **LIFTER, **FLAGS[flags])
    x, y = _lifter_inputs()

    def loss_fn(p):
        pred = fmodel.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(jnp.square(pred - y)), pred

    (want_loss, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    want_grads = temporal_lifter_from_flax(jax.tree.map(np.asarray, grads))
    model = TemporalLifter(**LIFTER, **FLAGS[flags], device="cpu")
    model.load_state_dict(temporal_lifter_from_flax(params), strict=True)
    pred, loss, got = _port_loss_grads(model, x, y)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=FWD_RTOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert set(got) == set(want_grads)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
def test_remat_is_bitwise_the_module(flash):
    from pose3d_tpu_torch.models.temporal import TemporalLifter

    x, y = _lifter_inputs()
    runs = []
    for remat in (False, True):
        model = TemporalLifter(**LIFTER, flash=flash, remat=remat, device="cpu")
        model.init_weights(torch.Generator().manual_seed(5))
        runs.append(_port_loss_grads(model, x, y))
    (p0, l0, g0), (p1, l1, g1) = runs
    assert torch.equal(p0, p1) and torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_flash_routes_the_temporal_half_only():
    from pose3d_tpu_torch.models.temporal import TemporalLifter

    model = TemporalLifter(**LIFTER, flash=True, device="cpu")
    assert all(b.temporal_attn.flash and not b.spatial_attn.flash for b in model.blocks)


def test_use_kernels_takes_precedence_over_flash(monkeypatch):
    """As ``use_pallas`` does in JAX: with both set the attention goes
    through the kernel wrappers (their plain versions here), never through
    flash attention."""
    from pose3d_tpu_torch.models import temporal as T

    x, _ = _lifter_inputs()
    model = T.TemporalLifter(**LIFTER, flash=True, use_kernels=True, device="cpu")
    model.init_weights(torch.Generator().manual_seed(5))
    want = model(torch.from_numpy(x))

    def refuse(*args, **kwargs):
        raise AssertionError("flash attention ran")

    monkeypatch.setattr(T, "flash_attention", refuse)
    assert torch.equal(model(torch.from_numpy(x)), want)
    with pytest.raises(AssertionError, match="flash attention ran"):
        model(torch.from_numpy(x), use_kernels=False)


def test_bridge_reads_a_remat_tree():
    """A flax tree built with ``remat=True`` names its blocks
    ``CheckpointSpatioTemporalBlock_i``: the bridge maps them (before, it
    returned no block weights and raised nothing), and a tree without
    blocks raises."""
    from torch_port_util import flax_temporal

    from pose3d_tpu_torch.interop.weights import temporal_lifter_from_flax
    from pose3d_tpu_torch.models.temporal import TemporalLifter

    _, plain = flax_temporal(seed=2, **LIFTER)
    _, remat = flax_temporal(seed=2, **LIFTER, remat=True)
    assert "CheckpointSpatioTemporalBlock_1" in remat and "SpatioTemporalBlock_0" not in remat
    a, b = temporal_lifter_from_flax(plain), temporal_lifter_from_flax(remat)
    assert a.keys() == b.keys() and any(k.startswith("blocks.1.") for k in b)
    blk = remat["CheckpointSpatioTemporalBlock_1"]
    np.testing.assert_array_equal(b["blocks.1.temporal_attn.qkv.weight"].numpy(),
                                  blk["_MHSA_1"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(b["blocks.1.spatial_norm2.weight"].numpy(),
                                  blk["LayerNorm_1"]["scale"])
    TemporalLifter(**LIFTER, device="cpu").load_state_dict(b, strict=True)
    bare = {k: v for k, v in remat.items() if not k.startswith("Checkpoint")}
    with pytest.raises(ValueError, match="CheckpointSpatioTemporalBlock_0"):
        temporal_lifter_from_flax(bare)
