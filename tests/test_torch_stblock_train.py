"""The port's training sub-blocks (``pose3d_tpu_torch/ops/stblock_train.py``)
against the JAX package's Pallas training kernels
(``pose3d_tpu/ops/pallas_stblock_train.py``) in interpret mode, and the
CUDA kernels against their plain versions on the card.

Inputs and weights are drawn with numpy from a seed and rounded to bf16
first, so the f32 and bf16 runs of both packages see the same values.
Spatial inputs span 2 x 272 rows and a partial cell (35 frames), so the
JAX kernels' accumulation across grid cells is part of what is compared;
the slab has 2 clips of 12 frames, and the joint-major sequences
(``sequences_fwd`` / ``sequences_bwd``, JAX's ``_temporal_fwd_impl`` /
``_temporal_bwd_impl``: one sequence per grid cell) are the same tokens
laid out as 34 sequences of 12. Tolerances, the JAX suite's own
(tests/test_pallas_stblock_train.py:44-81):

- f32 forward outputs and residuals: atol 1e-4 (the same expression, f32
  sums in another order; measured ~3e-6);
- f32 dx and each of the 12 weight gradients: atol 2e-5, rtol 2e-3
  (weight gradients sum ~600 rows in another order; output gradients
  2^-4 N(0, 1) keep them below |10|);
- bf16 forward outputs and residuals: two bf16 steps of the value,
  2^-6 + 2^-6 |want| (a different f32 sum order flips roundings that the
  bf16 residual stream carries on);
- bf16 gradients: the port's error against the JAX f32 run at most 1.5x
  the JAX bf16 kernel's (the two round the same intermediates to bf16, so
  their gradients differ by flipped roundings, not by a rule);
- ``temporal_block_train``'s autograd gradients against ``jax.grad`` of
  the JAX one through a vdot loss, f32: atol 1e-4, rtol 2e-3 (the JAX
  suite's limit for this comparison, test_pallas_stblock_train.py:158);
- joint-major against the slab on the same tokens, plain versions: out,
  x1, att and dx bitwise (each sequence is read in the same order); each
  weight gradient within f32 summation order, 2^-16 of its largest
  element + 2^-12·|want| (its row slices are summed in another order).

The tests marked ``cuda`` skip where there is no CUDA device.
"""

import math

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device

from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.ops import stblock as S
from pose3d_tpu_torch.ops import stblock_train as ST

torch.set_num_threads(2)

N_FRAMES = 35  # 595 rows: two 272-row cells of the JAX kernels and a partial one
CLIPS, CLIP_LEN = 2, 12
NAMES = [name for name, *_ in S._LAYOUT]
GRADS = ["dx"] + [f"d{n}" for n in NAMES]
HALVES = ["spatial", "slab", "sequences"]
FNS = {"spatial": (ST.spatial_fwd, ST.spatial_bwd), "slab": (ST.slab_fwd, ST.slab_bwd),
       "sequences": (ST.sequences_fwd, ST.sequences_bwd)}


def _joint_major(slab: np.ndarray) -> np.ndarray:
    """(C, T, 17·256) frame-major slab -> (C·17, T, 256) joint sequences."""
    c, t, _ = slab.shape
    return np.ascontiguousarray(slab.reshape(c, t, 17, 256).transpose(0, 2, 1, 3)).reshape(
        c * 17, t, 256)


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _weights(rng):
    """One sub-block's weights, in the kernels' layout, bf16-exact."""
    parts = []
    for name, shape, _, _ in S._LAYOUT:
        if len(shape) == 2:
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            a = 0.1 * rng.standard_normal(shape) + (1.0 if name.endswith("_g") else 0.0)
        parts.append(_bf16_exact(a.astype(np.float32)))
    return parts


def _split(flat: np.ndarray) -> dict:
    out, pos = {}, 0
    for name, shape, _, _ in S._LAYOUT:
        n = math.prod(shape)
        out[f"d{name}"] = flat[pos:pos + n]
        pos += n
    return out


@pytest.fixture(scope="module")
def cases():
    """Per (half, dtype): the inputs and the JAX kernels' outputs, residuals
    and gradients (interpret mode), as f32 numpy."""
    import jax.numpy as jnp

    from pose3d_tpu.ops import pallas_stblock_train as st

    rng = np.random.default_rng(0)
    weights = _weights(rng)
    shapes = {"spatial": (N_FRAMES * 17, 256), "slab": (CLIPS, CLIP_LEN, 17 * 256)}
    out = {}
    for half in HALVES:
        if half == "sequences":  # the slab's tokens and gradients, joint-major
            x, g = (_joint_major(out["slab", "f32"][k]) for k in ("x", "g"))
        else:
            x = _bf16_exact(rng.standard_normal(shapes[half]).astype(np.float32))
            # output gradients of a training loss are small: 2^-4 N(0, 1)
            g = _bf16_exact((2 ** -4 * rng.standard_normal(shapes[half])).astype(np.float32))
        for dname, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            jw = tuple(jnp.asarray(w.reshape(1, -1) if w.ndim == 1 else w, jdt)
                       for w in weights)
            if half == "spatial":
                o, res = st._spatial_fwd_impl(jnp.asarray(x, jdt), jw, True)
                dx, dws = st._spatial_bwd_impl(res, jnp.asarray(g, jdt), jw, True)
                n = shapes[half][0]
                res = tuple(r[:n] for r in res)
                dx = dx[:n]
            elif half == "slab":
                o, res = st._temporal_slab_fwd_impl(jnp.asarray(x, jdt), jw, True)
                dx, dws = st._temporal_slab_bwd_impl(res, jnp.asarray(g, jdt), jw, True)
            else:
                o, res = st._temporal_fwd_impl(jnp.asarray(x, jdt), jw, True)
                dx, dws = st._temporal_bwd_impl(res, jnp.asarray(g, jdt), jw, True)
            f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
            grads = {"dx": f32(dx), **_split(np.concatenate([f32(d).reshape(-1) for d in dws]))}
            out[half, dname] = {"x": x, "g": g, "fwd": {"out": f32(o), "x1": f32(res[1]),
                                                       "att": f32(res[2])}, "grads": grads}
    out["weights"] = np.concatenate([w.reshape(-1) for w in weights])
    return out


@pytest.fixture(scope="module")
def port(cases):
    """The port's plain versions on the same inputs, per (half, dtype)."""
    out = {}
    for half in HALVES:
        for dname in ("f32", "bf16"):
            dt = torch.float32 if dname == "f32" else torch.bfloat16
            c = cases[half, dname]
            w = S.SubBlockWeights(torch.from_numpy(cases["weights"]).to(dt))
            x = torch.from_numpy(c["x"]).to(dt)
            g = torch.from_numpy(c["g"]).to(dt)
            fwd, bwd = FNS[half]
            o, x1, att = fwd(x, w)
            dx, dw = bwd(x, x1, att, g, w)
            f32 = lambda t: t.float().numpy()  # noqa: E731
            out[half, dname] = {"fwd": {"out": f32(o), "x1": f32(x1), "att": f32(att)},
                                "grads": {"dx": f32(dx), **_split(dw.numpy())}}
    return out


class TestPlainAgainstJax:
    @pytest.mark.parametrize("what", ["out", "x1", "att"])
    @pytest.mark.parametrize("half", HALVES)
    def test_forward_f32(self, cases, port, half, what):
        np.testing.assert_allclose(port[half, "f32"]["fwd"][what],
                                   cases[half, "f32"]["fwd"][what], atol=1e-4, rtol=0)

    @pytest.mark.parametrize("what", ["out", "x1", "att"])
    @pytest.mark.parametrize("half", HALVES)
    def test_forward_bf16(self, cases, port, half, what):
        got = port[half, "bf16"]["fwd"][what]
        want = cases[half, "bf16"]["fwd"][what]
        excess = np.abs(got - want) - (2 ** -6 + 2 ** -6 * np.abs(want))
        assert excess.max() <= 0, f"max abs err {np.abs(got - want).max():.3g}"

    @pytest.mark.parametrize("what", GRADS)
    @pytest.mark.parametrize("half", HALVES)
    def test_backward_f32(self, cases, port, half, what):
        np.testing.assert_allclose(port[half, "f32"]["grads"][what],
                                   cases[half, "f32"]["grads"][what], atol=2e-5, rtol=2e-3)

    @pytest.mark.parametrize("what", GRADS)
    @pytest.mark.parametrize("half", HALVES)
    def test_backward_bf16_as_accurate_as_jax(self, cases, port, half, what):
        ref = cases[half, "f32"]["grads"][what]
        err_port = np.abs(port[half, "bf16"]["grads"][what] - ref).max()
        err_jax = np.abs(cases[half, "bf16"]["grads"][what] - ref).max()
        assert err_port <= 1.5 * err_jax + 1e-6 * np.abs(ref).max(), (err_port, err_jax)


class TestJointMajor:
    @pytest.mark.parametrize("dname", ["f32", "bf16"])
    def test_sequences_equal_the_slab_relaid(self, port, dname):
        """The plain joint-major route on the slab's tokens, joint-major:
        out, x1, att and dx bitwise; each weight gradient within f32
        summation order (see the module docstring)."""
        seq, slab = port["sequences", dname], port["slab", dname]
        for what in ("out", "x1", "att"):
            np.testing.assert_array_equal(seq["fwd"][what], _joint_major(slab["fwd"][what]))
        np.testing.assert_array_equal(seq["grads"]["dx"], _joint_major(slab["grads"]["dx"]))
        for what in GRADS[1:]:
            want = slab["grads"][what]
            np.testing.assert_allclose(seq["grads"][what], want, rtol=2 ** -12,
                                       atol=2 ** -16 * np.abs(want).max(), err_msg=what)

    def test_autograd_matches_jax_grad(self, cases):
        """``temporal_block_train``'s gradients of a vdot loss, dx and the 12
        weight gradients, against ``jax.grad`` of the JAX
        ``temporal_block_train`` (interpret mode), f32: atol 1e-4, rtol
        2e-3 (the module docstring)."""
        import jax
        import jax.numpy as jnp

        from pose3d_tpu.ops import pallas_stblock_train as st

        c = cases["sequences", "f32"]
        parts = S.SubBlockWeights(torch.from_numpy(cases["weights"])).parts().values()
        jw = [jnp.asarray(w.numpy().reshape(1, -1) if w.dim() == 1 else w.numpy())
              for w in parts]
        dout = jnp.asarray(c["g"])

        def loss(x, *ws):
            return jnp.vdot(st.temporal_block_train(x, *ws, True), dout)

        want = jax.grad(loss, argnums=tuple(range(13)))(jnp.asarray(c["x"]), *jw)
        x = torch.from_numpy(c["x"]).requires_grad_(True)
        flat = torch.from_numpy(cases["weights"]).requires_grad_(True)
        out = ST.temporal_block_train(x, flat)
        (out * torch.from_numpy(c["g"])).sum().backward()
        assert flat.grad.dtype == torch.float32 and x.grad.shape == x.shape
        got = [x.grad] + list(S.SubBlockWeights(flat.grad).parts().values())
        for name, a, b in zip(GRADS, got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape), atol=1e-4,
                                       rtol=2e-3, err_msg=name)


class TestNumerics:
    """The backward's elementwise math against the JAX kernels' helpers,
    f32 on a grid through the erf clamp at |x| = 3: the same expressions,
    so within f32 rounding (atol 1e-6 on values below ~|1.2|)."""

    X = np.concatenate([np.linspace(-6, 6, 1201), [-3.0, 3.0, -4.2426405, 4.2426405]]
                       ).astype(np.float32)

    @pytest.mark.parametrize("name", ["erf_grad", "gelu_grad"])
    def test_derivatives_match_jax(self, name):
        from pose3d_tpu.ops import pallas_lifter, pallas_stblock_train

        from pose3d_tpu_torch.ops import numerics

        jax_fn = {"erf_grad": pallas_lifter._erf_grad,
                  "gelu_grad": pallas_stblock_train._gelu_grad}[name]
        want = np.asarray(jax_fn(self.X))
        got = getattr(numerics, name)(torch.from_numpy(self.X)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    def test_erf_grad_is_zero_from_the_clamp_on(self):
        from pose3d_tpu_torch.ops import numerics

        x = torch.tensor([-3.0, 3.0, 3.5, -2.999])
        assert numerics.erf_grad(x)[:3].abs().max() == 0 and numerics.erf_grad(x)[3] > 0

    def test_gelu_grad_is_the_derivative_of_gelu(self):
        """Against f64 autograd of the polynomial GELU; gelu_grad evaluates
        in f32, where 1 + erf(u) cancels near u = -3 (atol 3e-5)."""
        from pose3d_tpu_torch.ops import numerics

        x = torch.linspace(-5, 5, 401, dtype=torch.float64).requires_grad_(True)
        (numerics.erf(x / np.sqrt(2.0)) * x * 0.5 + 0.5 * x).sum().backward()
        np.testing.assert_allclose(numerics.gelu_grad(x.detach()).numpy(), x.grad.numpy(),
                                   atol=3e-5)

    def test_layer_norm_pieces_match_jax(self):
        from pose3d_tpu.ops import pallas_stblock_train as st

        from pose3d_tpu_torch.ops import numerics

        rng = np.random.default_rng(5)
        x = rng.standard_normal((8, 256)).astype(np.float32) * 3 + 1
        dy = rng.standard_normal((8, 256)).astype(np.float32)
        xhat_j, r_j = (np.asarray(a) for a in st._ln_fwd_stats(x))
        xhat, r = numerics.ln_fwd_stats(torch.from_numpy(x))
        np.testing.assert_allclose(xhat.numpy(), xhat_j, atol=1e-5)
        np.testing.assert_allclose(r.numpy(), r_j, rtol=1e-6)
        want = np.asarray(st._ln_bwd_input(dy, xhat_j, r_j))
        got = numerics.ln_bwd_input(torch.from_numpy(dy), xhat, r).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def _model(seed=0, n_blocks=1, clip_len=CLIP_LEN):
    return TemporalLifter(clip_len=clip_len, n_blocks=n_blocks, device="cpu").init_weights(
        torch.Generator().manual_seed(seed))


class TestAutograd:
    @pytest.mark.parametrize("half", ["spatial", "temporal", "sequences"])
    def test_pack_is_differentiable(self, half):
        """Every parameter of the block's half gets a nonzero gradient
        through the training Function (a pack built from the state dict
        would give none); "sequences" is the temporal half through
        ``temporal_block_train``."""
        model = _model()
        blk = model.blocks[0]
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.standard_normal((2 * CLIP_LEN * 17, 256)).astype(np.float32))
        if half == "sequences":
            half = "temporal"
            out = ST.temporal_block_train(x.view(2 * 17, CLIP_LEN, -1),
                                          ST.pack_train(blk, half, torch.float32).flat)
        elif half == "spatial":
            out = ST.SpatialBlockTrain.apply(x, ST.pack_train(blk, half, torch.float32).flat)
        else:
            out = ST.TemporalSlabTrain.apply(x.view(2, CLIP_LEN, -1),
                                             ST.pack_train(blk, half, torch.float32).flat)
        (out.float() * torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
         ).sum().backward()
        for name, p in blk.named_parameters():
            if name.startswith(half):
                assert p.grad is not None and p.grad.abs().max() > 0, name
            else:
                assert p.grad is None, name

    def test_function_grads_equal_the_wrappers(self):
        """The Function hands autograd the wrapper's dx and weight gradients
        (cast to the flat weights' dtype)."""
        model = _model()
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal((CLIP_LEN * 17, 256)).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((CLIP_LEN * 17, 256)).astype(np.float32))
        flat = ST.pack_train(model.blocks[0], "spatial", torch.float32).flat.detach()
        flat.requires_grad_(True)
        xr = x.clone().requires_grad_(True)
        ST.SpatialBlockTrain.apply(xr, flat).backward(g)
        w = S.SubBlockWeights(flat.detach())
        _, x1, att = ST.spatial_fwd(x, w)
        dx, dw = ST.spatial_bwd(x, x1, att, g, w)
        assert torch.equal(xr.grad, dx) and torch.equal(flat.grad, dw)

    def test_wrappers_run_the_plain_version_on_cpu(self):
        model = _model()
        w = ST.pack_train(model.blocks[0], "spatial", torch.float32)
        x = torch.randn(17, 256, generator=torch.Generator().manual_seed(3))
        before = [f.launches for f in ST.WRAPPERS]
        with torch.no_grad():
            got = ST.spatial_fwd(x, w)
            want = ST.spatial_fwd_reference(x, w)
            seqs = x.view(1, 17, 256)
            got_seq = ST.sequences_fwd(seqs, w)
            want_seq = ST.sequences_fwd_reference(seqs, w)
            got_bwd = ST.sequences_bwd(seqs, *got_seq[1:], seqs, w)
            want_bwd = ST.sequences_bwd_reference(seqs, *got_seq[1:], seqs, w)
        for a, b in zip((*got, *got_seq, *got_bwd), (*want, *want_seq, *want_bwd)):
            assert torch.equal(a, b)
        assert [f.launches for f in ST.WRAPPERS] == before

    @pytest.mark.parametrize("case", ["rows", "slab", "residual", "widths", "sequences",
                                      "sequence_residual"])
    def test_rejects_bad_operands(self, case):
        model = _model()
        w = ST.pack_train(model.blocks[0], "spatial", torch.float32)
        x = torch.zeros(34, 256)
        with pytest.raises(ValueError):
            if case == "rows":
                ST.spatial_fwd(x[:20], w)
            elif case == "slab":
                ST.slab_fwd(x.view(2, 17, 256), w)
            elif case == "residual":
                ST.spatial_bwd(x, x, x[:17], x, w)
            elif case == "sequences":
                ST.sequences_fwd(x.view(2, 34, 128), w)
            elif case == "sequence_residual":
                seqs = x.view(2, 17, 256)
                ST.sequences_bwd(seqs, seqs, seqs[:1], seqs, w)
            else:
                ST.temporal_train_forward_fused(
                    TemporalLifter(clip_len=4, hidden=64, heads=4, n_blocks=1, device="cpu"),
                    torch.zeros(1, 4, 17, 2))


@pytest.mark.cuda
class TestTrainKernels:
    """The CUDA kernels against their plain versions on the card, at T = 243
    on one clip (243 frames, a ragged last spatial tile; 17 joint-major
    sequences) and two. Forward
    rows: 5e-2 + 2^-5·|want| (the serving kernels' bound); gradients:
    2^-7 of the tensor's largest element + 2^-7·|want| (flipped bf16
    roundings of dh, dqkv and dx1, measured ~0.1% of the largest element).
    The backward recomputes y, qkv and the hidden with its own products,
    not the forward kernels' (a wgmma engine since the forward's redesign),
    so a step's gradients may differ from a step on plain forwards by such
    flipped roundings too; the whole-step limits of PERF.md §2 (relative L2
    5e-2, checked by chip_smoke.py) cover that."""

    @staticmethod
    def _setup(clips, half, seed=0, clip_len=243):
        dev = cuda_device()
        model = TemporalLifter(clip_len=clip_len, n_blocks=1, device="cpu").init_weights(
            torch.Generator().manual_seed(seed)).to(dev)
        gen = torch.Generator().manual_seed(seed + 1)
        kp = torch.rand(clips, model.clip_len, 17, 2, generator=gen).to(dev)
        with torch.no_grad():
            x = ST.embed_clips(model, kp, torch.bfloat16)
            w = ST.pack_train(model.blocks[0], "spatial" if half == "spatial" else "temporal",
                              torch.bfloat16)
        g = (torch.randn(x.shape, generator=gen) * 2 ** -6).to(dev, torch.bfloat16)
        if half == "temporal":
            x, g = x.view(clips, model.clip_len, -1), g.view(clips, model.clip_len, -1)
        elif half == "sequences":
            x, g = S.joint_major(x, clips), S.joint_major(g, clips)
        return x, g, w

    @staticmethod
    def _fns(half):
        if half == "spatial":
            return ST.spatial_fwd, ST.spatial_bwd, ST.spatial_fwd_reference, \
                ST.spatial_bwd_reference
        if half == "sequences":
            return ST.sequences_fwd, ST.sequences_bwd, ST.sequences_fwd_reference, \
                ST.sequences_bwd_reference
        return ST.slab_fwd, ST.slab_bwd, ST.slab_fwd_reference, ST.slab_bwd_reference

    @pytest.mark.parametrize("clips", [1, 2])
    @pytest.mark.parametrize("half", ["spatial", "temporal", "sequences"])
    def test_forward_matches_plain(self, half, clips):
        x, _, w = self._setup(clips, half)
        fwd, _, fref, _ = self._fns(half)
        before = fwd.launches
        with torch.no_grad():
            got, want = fwd(x, w), fref(x, w)
        torch.cuda.synchronize()
        assert fwd.launches == before + 1
        for a, b in zip(got, want):
            a, b = a.float().cpu(), b.float().cpu()
            assert ((a - b).abs() - (5e-2 + 2 ** -5 * b.abs())).max() <= 0

    # 243 frames as served; 3 x 81: 4,131 rows, a ragged last 128-row tile and
    # a ragged last 64-row chunk of the weight gradients' K slices; sequences
    # of L = 17 and of the longest, 256; 16 x 243, the benchmark's half step:
    # 66,096 rows, ~4 row tiles a persistent CTA, so every barrier of the
    # MLP backward's tile walk turns over several times
    @pytest.mark.parametrize("clips,clip_len", [(1, 243), (2, 243), (3, 81), (2, 17), (1, 256),
                                                (16, 243)])
    @pytest.mark.parametrize("half", ["spatial", "temporal", "sequences"])
    def test_backward_matches_plain_and_is_deterministic(self, half, clips, clip_len):
        x, g, w = self._setup(clips, half, clip_len=clip_len)
        _, bwd, fref, bref = self._fns(half)
        before = bwd.launches
        with torch.no_grad():
            _, x1, att = fref(x, w)
            dx, dw = bwd(x, x1, att, g, w)
            dx2, dw2 = bwd(x, x1, att, g, w)
            want = bref(x, x1, att, g, w)
        torch.cuda.synchronize()
        assert bwd.launches == before + 2
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
        parts = [("dx", dx, want[0])] + [
            (k, _split(dw.cpu().numpy())[k], _split(want[1].cpu().numpy())[k])
            for k in GRADS[1:]]
        for name, a, b in parts:
            a, b = torch.as_tensor(a).float().cpu(), torch.as_tensor(b).float().cpu()
            assert torch.isfinite(a).all(), name
            tol = 2 ** -7 * b.abs().max() + 2 ** -7 * b.abs()
            assert ((a - b).abs() - tol).max() <= 0, name

    def test_sequences_match_the_slab_kernels(self):
        """The joint-major kernels on the slab's tokens, re-laid: out, x1,
        att and dx bitwise; each weight gradient within f32 summation order
        (relative L2 below 1e-5)."""
        x, g, w = self._setup(2, "temporal")
        xs, gs = (S.joint_major(t.reshape(-1, 256), 2) for t in (x, g))
        with torch.no_grad():
            slab = ST.slab_fwd(x, w)
            seq = ST.sequences_fwd(xs, w)
            dx, dw = ST.slab_bwd(x, *slab[1:], g, w)
            dxs, dws = ST.sequences_bwd(xs, *seq[1:], gs, w)
        torch.cuda.synchronize()
        for a, b in zip((*slab, dx), (*seq, dxs)):
            assert torch.equal(S.joint_major(a.reshape(-1, 256), 2), b)
        for k in GRADS[1:]:
            a, b = (torch.from_numpy(_split(t.cpu().numpy())[k]) for t in (dws, dw))
            assert ((a - b).norm() / b.norm()).item() < 1e-5, k

    def test_temporal_block_train_reaches_the_weights(self):
        """On the card the output has a grad_fn, one backward launches the
        backward kernels once and reaches the flat weights; f32 is refused."""
        x, g, w = self._setup(1, "sequences")
        flat = w.flat.detach().requires_grad_(True)
        xr = x.detach().requires_grad_(True)
        before = (ST.sequences_fwd.launches, ST.sequences_bwd.launches)
        out = ST.temporal_block_train(xr, flat)
        assert out.grad_fn is not None
        out.backward(g)
        torch.cuda.synchronize()
        assert (ST.sequences_fwd.launches, ST.sequences_bwd.launches) == (
            before[0] + 1, before[1] + 1)
        assert flat.grad.dtype == torch.bfloat16 and torch.isfinite(flat.grad.float()).all()
        assert flat.grad.abs().max() > 0 and xr.grad.shape == x.shape
        with pytest.raises(TypeError, match="bfloat16"):
            ST.temporal_block_train(x.float(), w.flat.float())

    def test_train_forward_launches_each_wrapper_per_block(self):
        dev = cuda_device()
        model = TemporalLifter(n_blocks=2, device="cpu").init_weights(
            torch.Generator().manual_seed(0)).to(dev)
        kp = torch.rand(1, model.clip_len, 17, 2, generator=torch.Generator().manual_seed(1))
        before = [f.launches for f in ST.WRAPPERS]
        ST.temporal_train_forward_fused(model, kp.to(dev)).square().mean().backward()
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(ST.WRAPPERS, before)] == [2, 2, 2, 2, 0, 0]
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in model.parameters())
