"""The port's temporal sub-blocks and fused serving forward
(``pose3d_tpu_torch/ops/stblock.py``) against the JAX package's Pallas
kernels (``pose3d_tpu/ops/pallas_stblock.py``) in interpret mode, on the
same flax-initialised weights (``temporal_lifter_from_flax``), and the
CUDA kernels against their plain versions on the card.

Both sides compute GELU on the same clamped polynomial erf and softmax
without a row max; the flax module computes the exact erf and softmax.
Tolerances, the JAX package's own (tests/test_pallas_stblock.py):

- plain fused forward vs the JAX fused forward: 5e-2 on the (C, T, 17, 3)
  outputs (measured 2.3e-2 here: f32 sums in another order flip bf16
  roundings of the residual stream);
- plain fused forward (bf16) vs the f32 flax apply: 0.1;
- sub-block rows, which reach |6| where one bf16 step is 2^-5: 5e-2 +
  2^-5·|want| (measured one step);
- the joint-major ``temporal_block_fused`` (plain) against the JAX
  ``temporal_block_fused`` in interpret mode, on weights bridged by
  ``sub_block_from_jax``: f32 atol 1e-4 (the same expression, f32 sums in
  another order), bf16 2^-6 + 2^-6·|want| (two bf16 steps: a flipped
  rounding rides the residual stream), as the training slab's limits;
- the joint-major route against the slab route on the same tokens, re-laid:
  bitwise, on the CPU as on the card (each sequence is read in the same
  order).

The tests marked ``cuda`` skip where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, flax_apply, flax_temporal, torch_temporal

from pose3d_tpu_torch.interop.weights import sub_block_from_jax
from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.ops import stblock as S
from pose3d_tpu_torch.ops import stblock_train as ST

torch.set_num_threads(2)

CLIPS, CLIP_LEN, N_BLOCKS = 4, 27, 2
FIELDS = {"clip_len": CLIP_LEN, "n_blocks": N_BLOCKS}


def _rows_close(got, want):
    """Sub-block rows: 5e-2 + 2^-5·|want| (see the module docstring)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    excess = np.abs(got - want) - (5e-2 + 2 ** -5 * np.abs(want))
    assert excess.max() <= 0, f"max abs err {np.abs(got - want).max():.3g}"


@pytest.fixture(scope="module")
def setup():
    """flax TemporalLifter(clip_len=27, n_blocks=2) params, the port's bf16
    copy, seeded clips and tokens, and the JAX kernels' outputs on them
    (interpret mode, run once for the module)."""
    import jax.numpy as jnp

    from pose3d_tpu.ops import pallas_stblock as ps

    fmodel, params = flax_temporal(seed=0, **FIELDS)
    clips = np.random.default_rng(3).random((CLIPS, CLIP_LEN, 17, 2)).astype(np.float32)
    tokens = np.random.default_rng(5).standard_normal(
        (CLIPS * CLIP_LEN * 17, 256)).astype(np.float32)
    tok = jnp.asarray(tokens, jnp.bfloat16)
    bp = params["SpatioTemporalBlock_0"]
    seqs = _joint_major_np(tokens)
    return {
        "seqs": seqs,
        "jax_block": {name: np.asarray(ps.temporal_block_fused(
            jnp.asarray(seqs, jdt), ps.pack_temporal_weights(bp, dtype=jdt),
            interpret=True).astype(jnp.float32)) for name, jdt in
            (("f32", jnp.float32), ("bf16", jnp.bfloat16))},
        "flax": fmodel,
        "params": params,
        "bf16": torch_temporal(params, dtype=torch.bfloat16, **FIELDS),
        "clips": clips,
        "tokens": torch.from_numpy(tokens).to(torch.bfloat16),
        "jax_spatial": np.asarray(ps.spatial_block_fused(
            tok, ps.pack_spatial_weights(bp), interpret=True).astype(jnp.float32)),
        "jax_temporal": np.asarray(ps.temporal_slab_fused(
            tok.reshape(CLIPS, CLIP_LEN, 17 * 256), ps.pack_temporal_weights(bp),
            interpret=True).astype(jnp.float32)),
        "jax_fused": np.asarray(ps.temporal_forward_fused(
            params, jnp.asarray(clips), n_blocks=N_BLOCKS, clip_len=CLIP_LEN,
            interpret=True)),
    }


def _joint_major_np(tokens: np.ndarray) -> np.ndarray:
    """(C·T·17, 256) frame-major token rows -> (C·17, T, 256) sequences."""
    return np.ascontiguousarray(tokens.reshape(CLIPS, CLIP_LEN, 17, 256).transpose(
        0, 2, 1, 3)).reshape(CLIPS * 17, CLIP_LEN, 256)


def _fused(model, clips):
    with torch.no_grad():
        return S.temporal_forward_fused(model, torch.from_numpy(clips))


class TestPlainAgainstJax:
    @pytest.mark.parametrize("half", ["spatial", "temporal"])
    def test_pack_weights_follow_jax_order(self, setup, half):
        from pose3d_tpu.ops import pallas_stblock as ps

        pack_jax = getattr(ps, f"pack_{half}_weights")
        want = [np.asarray(a, np.float32).reshape(-1) for a in pack_jax(
            setup["params"]["SpatioTemporalBlock_1"], dtype=np.float32)]
        got = getattr(S, f"pack_{half}_weights")(torch_temporal(setup["params"], **FIELDS)
                                                  .blocks[1])
        assert got.flat.dtype == torch.float32 and got.flat.numel() == S.BLOCK_ELEMS
        np.testing.assert_array_equal(got.flat.numpy(), np.concatenate(want))

    def test_spatial_reference_matches_jax_kernel(self, setup):
        w = S.pack_spatial_weights(setup["bf16"].blocks[0])
        got = S.spatial_block(setup["tokens"], w)
        assert got.dtype == torch.bfloat16 and got.shape == setup["tokens"].shape
        _rows_close(got.float().numpy(), setup["jax_spatial"])

    def test_temporal_reference_matches_jax_kernel(self, setup):
        w = S.pack_temporal_weights(setup["bf16"].blocks[0])
        slab = setup["tokens"].view(CLIPS, CLIP_LEN, 17 * 256)
        got = S.temporal_slab(slab, w)
        assert got.shape == slab.shape
        _rows_close(got.float().numpy(), setup["jax_temporal"])

    @pytest.mark.parametrize("dname", ["f32", "bf16"])
    def test_joint_major_reference_matches_jax_kernel(self, setup, dname):
        """``temporal_block_fused`` (plain) on ``sub_block_from_jax`` weights
        against the JAX kernel on the same weights and sequences."""
        import jax.numpy as jnp

        from pose3d_tpu.ops import pallas_stblock as ps

        dt, jdt = {"f32": (torch.float32, jnp.float32),
                   "bf16": (torch.bfloat16, jnp.bfloat16)}[dname]
        w = sub_block_from_jax(ps.pack_temporal_weights(
            setup["params"]["SpatioTemporalBlock_0"], dtype=jdt), dt)
        x = torch.from_numpy(setup["seqs"]).to(dt)
        got = S.temporal_block_fused(x, w)
        assert got.dtype == dt and got.shape == x.shape
        want = setup["jax_block"][dname]
        if dname == "f32":
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        else:
            excess = np.abs(got.float().numpy() - want) - (2 ** -6 + 2 ** -6 * np.abs(want))
            assert excess.max() <= 0, f"max abs err {np.abs(got.float().numpy() - want).max()}"

    @pytest.mark.parametrize("half", ["spatial", "temporal"])
    def test_sub_block_from_jax_equals_the_pack(self, setup, half):
        """``sub_block_from_jax`` of the JAX pack in f32 is the port's pack of
        the same block, exactly."""
        from pose3d_tpu.ops import pallas_stblock as ps

        bp = setup["params"]["SpatioTemporalBlock_1"]
        got = sub_block_from_jax(getattr(ps, f"pack_{half}_weights")(bp, dtype=np.float32))
        want = getattr(S, f"pack_{half}_weights")(torch_temporal(setup["params"], **FIELDS)
                                                   .blocks[1])
        assert got.flat.dtype == torch.float32 and torch.equal(got.flat, want.flat)

    def test_fused_matches_jax_fused(self, setup):
        got = _fused(setup["bf16"], setup["clips"])
        assert got.dtype == torch.float32 and got.shape == (CLIPS, CLIP_LEN, 17, 3)
        err = np.abs(got.numpy() - setup["jax_fused"]).max()
        assert err < 5e-2, f"max abs err {err}"

    def test_fused_close_to_f32_flax_apply(self, setup):
        want = flax_apply(setup["flax"], setup["params"], setup["clips"])
        err = np.abs(_fused(setup["bf16"], setup["clips"]).numpy() - want).max()
        assert err < 0.1, f"max abs err {err}"


class TestPlainPath:
    def test_clip_isolation(self, setup):
        """Perturbing clip 0 leaves every other clip bit-identical."""
        base = _fused(setup["bf16"], setup["clips"])
        clips = setup["clips"].copy()
        clips[0] += 1.0
        pert = _fused(setup["bf16"], clips)
        assert torch.equal(base[1:], pert[1:])
        assert not torch.equal(base[0], pert[0])

    def test_spatial_frame_isolation(self, setup):
        w = S.pack_spatial_weights(setup["bf16"].blocks[0])
        x = setup["tokens"][:8 * 17]
        pert = x.clone()
        pert[:17] += 1.0
        base, out = S.spatial_block(x, w), S.spatial_block(pert, w)
        assert torch.equal(base[17:], out[17:])
        assert not torch.equal(base[:17], out[:17])

    def test_wrappers_run_the_plain_version_on_cpu(self, setup):
        blk = setup["bf16"].blocks[1]
        ws, wt = S.pack_spatial_weights(blk), S.pack_temporal_weights(blk)
        x = setup["tokens"]
        slab = x.view(CLIPS, CLIP_LEN, -1)
        seqs = S.joint_major(x, CLIPS)
        counters = (S.spatial_block, S.temporal_slab, S.temporal_block_fused)
        before = [f.launches for f in counters]
        assert torch.equal(S.spatial_block(x, ws), S.spatial_block_reference(x, ws))
        assert torch.equal(S.temporal_slab(slab, wt), S.temporal_slab_reference(slab, wt))
        assert torch.equal(S.temporal_block_fused(seqs, wt),
                           S.temporal_block_reference(seqs, wt))
        assert [f.launches for f in counters] == before

    @pytest.mark.parametrize("dname", ["f32", "bf16"])
    def test_joint_major_equals_the_slab_relaid(self, setup, dname):
        """The plain joint-major sub-block on the slab's tokens, re-laid, is
        the plain slab sub-block bit for bit."""
        dt = torch.float32 if dname == "f32" else torch.bfloat16
        wt = S.pack_temporal_weights(torch_temporal(setup["params"], dtype=dt, **FIELDS)
                                     .blocks[0])
        x = setup["tokens"].to(dt)
        slab = S.temporal_slab(x.view(CLIPS, CLIP_LEN, -1), wt)
        got = S.temporal_block_fused(S.joint_major(x, CLIPS), wt)
        assert torch.equal(got, S.joint_major(slab.view(-1, 256), CLIPS))

    def test_sequence_isolation(self, setup):
        """Perturbing one sequence leaves every other bit-identical."""
        wt = S.pack_temporal_weights(setup["bf16"].blocks[0])
        seqs = S.joint_major(setup["tokens"], CLIPS)
        pert = seqs.clone()
        pert[3] += 1.0
        base, out = S.temporal_block_fused(seqs, wt), S.temporal_block_fused(pert, wt)
        keep = torch.arange(len(seqs)) != 3
        assert torch.equal(base[keep], out[keep]) and not torch.equal(base[3], out[3])

    def test_pack_rejects_other_widths(self):
        model = TemporalLifter(clip_len=8, hidden=64, heads=4, n_blocks=1, device="cpu")
        with pytest.raises(ValueError, match="kernel takes"):
            S.pack_spatial_weights(model.blocks[0])
        with pytest.raises(ValueError, match="hidden 256"):
            S.temporal_forward_fused(model, torch.zeros(1, 8, 17, 2))

    @pytest.mark.parametrize("case", ["rows", "slab", "dtype", "clip_len", "sequences"])
    def test_rejects_bad_operands(self, setup, case):
        model = setup["bf16"]
        w = S.pack_spatial_weights(model.blocks[0])
        x = setup["tokens"]
        with pytest.raises(ValueError):
            if case == "rows":
                S.spatial_block(x[:20], w)
            elif case == "slab":
                S.temporal_slab(x.view(-1, 256, 17), w)
            elif case == "dtype":
                S.spatial_block(x.float(), w)
            elif case == "sequences":
                S.temporal_block_fused(x.view(-1, 17, 512), w)
            else:
                S.temporal_forward_fused(model, torch.zeros(1, CLIP_LEN - 1, 17, 2))


@pytest.mark.cuda
class TestSubBlockKernels:
    """The CUDA kernels against their plain versions on the card, on the
    embedded tokens of seeded clips at full width (T = 243). Sub-block
    rows: 5e-2 + 2^-5·|want|; the fused forward's outputs: 5e-2."""

    @staticmethod
    def _setup(dev, clips, n_blocks=1, seed=0):
        model = TemporalLifter(n_blocks=n_blocks, device="cpu").init_weights(
            torch.Generator().manual_seed(seed))
        model = model.to(device=dev, dtype=torch.bfloat16).eval().requires_grad_(False)
        kp = torch.rand(clips, model.clip_len, 17, 2,
                        generator=torch.Generator().manual_seed(seed + 1)).to(dev)
        emb = model.embed
        tokens = (kp.reshape(-1, 2).to(torch.bfloat16) @ emb.weight.t() + emb.bias)
        return model, kp, tokens.contiguous()

    @pytest.mark.parametrize("clips", [1, 3])
    def test_spatial_kernel_matches_plain(self, clips):
        dev = cuda_device()
        model, _, tokens = self._setup(dev, clips)
        w = S.pack_spatial_weights(model.blocks[0])
        before = S.spatial_block.launches
        got = S.spatial_block(tokens, w)
        torch.cuda.synchronize()
        assert S.spatial_block.launches == before + 1
        _rows_close(got.float().cpu(), S.spatial_block_reference(tokens, w).float().cpu())

    @pytest.mark.parametrize("clips", [1, 3])
    def test_temporal_kernel_matches_plain(self, clips):
        dev = cuda_device()
        model, _, tokens = self._setup(dev, clips)
        w = S.pack_temporal_weights(model.blocks[0])
        slab = tokens.view(clips, model.clip_len, -1)
        before = S.temporal_slab.launches
        got = S.temporal_slab(slab, w)
        torch.cuda.synchronize()
        assert S.temporal_slab.launches == before + 1
        _rows_close(got.float().cpu(), S.temporal_slab_reference(slab, w).float().cpu())

    @pytest.mark.parametrize("clips", [1, 3])
    def test_joint_major_kernel_matches_plain_and_the_slab(self, clips):
        """``temporal_block_fused`` on the card: rows against its plain
        version, one count a call, two calls bitwise equal, and bitwise
        equal to the slab kernel on the same tokens."""
        dev = cuda_device()
        model, _, tokens = self._setup(dev, clips)
        w = S.pack_temporal_weights(model.blocks[0])
        seqs = S.joint_major(tokens, clips)
        before = S.temporal_block_fused.launches
        got, again = S.temporal_block_fused(seqs, w), S.temporal_block_fused(seqs, w)
        slab = S.temporal_slab(tokens.view(clips, model.clip_len, -1), w)
        torch.cuda.synchronize()
        assert S.temporal_block_fused.launches == before + 2
        assert torch.equal(got, again)
        assert torch.equal(got, S.joint_major(slab.view(-1, 256), clips))
        _rows_close(got.float().cpu(), S.temporal_block_reference(seqs, w).float().cpu())

    def test_joint_major_kernel_refuses_f32_and_long_sequences(self):
        dev = cuda_device()
        model = TemporalLifter(n_blocks=1, device=dev)
        w = S.pack_temporal_weights(model.blocks[0])
        with pytest.raises(TypeError, match="bfloat16"):
            S.temporal_block_fused(torch.zeros(2, 16, 256, device=dev), w)
        wb = S.SubBlockWeights(w.flat.to(torch.bfloat16))
        with pytest.raises(ValueError, match="do not fit in shared memory"):
            S.temporal_block_fused(torch.zeros(1, 1441, 256, device=dev, dtype=torch.bfloat16),
                                   wb)

    def test_slab_kernel_takes_the_longest_clip(self):
        dev = cuda_device()
        model = TemporalLifter(n_blocks=1, device=dev)
        w = S.SubBlockWeights(S.pack_temporal_weights(model.blocks[0]).flat.to(torch.bfloat16))
        x = torch.randn(1, 1440, 17 * 256, generator=torch.Generator().manual_seed(0)).to(
            dev, torch.bfloat16)
        out = S.temporal_slab(x, w)
        assert out.shape == x.shape and torch.isfinite(out).all()
        with pytest.raises(ValueError, match="do not fit in shared memory"):
            S.temporal_slab(torch.zeros(1, 1441, 17 * 256, device=dev, dtype=torch.bfloat16), w)

    def test_kernels_isolate_clips_and_frames(self):
        dev = cuda_device()
        model, _, tokens = self._setup(dev, 2)
        ws = S.pack_spatial_weights(model.blocks[0])
        wt = S.pack_temporal_weights(model.blocks[0])
        pert = tokens.clone()
        pert[:17] += 1.0
        base, out = S.spatial_block(tokens, ws), S.spatial_block(pert, ws)
        assert torch.equal(base[17:], out[17:]) and not torch.equal(base[:17], out[:17])
        t = model.clip_len
        base = S.temporal_slab(tokens.view(2, t, -1), wt)
        out = S.temporal_slab(pert.view(2, t, -1), wt)
        assert torch.equal(base[1:], out[1:]) and not torch.equal(base[0], out[0])

    def test_fused_forward_matches_plain(self):
        dev = cuda_device()
        model, kp, _ = self._setup(dev, 2, n_blocks=2)
        before = (S.spatial_block.launches, S.temporal_slab.launches)
        got = S.temporal_forward_fused(model, kp)
        assert (S.spatial_block.launches, S.temporal_slab.launches) == (
            before[0] + 2, before[1] + 2)
        want = _plain_fused(model, kp)
        err = (got - want).abs().max().item()
        assert err < 5e-2, f"max abs err {err}"

    @pytest.mark.parametrize("frames", [1, 7, 8, 486])
    def test_ragged_tiles_match_plain(self, frames):
        """Row counts that are not a multiple of the 128-row tile (17, 119,
        136, 8262 rows): the spatial half on frames, the slab on one clip of
        that many frames and the joint-major route on its re-laid tokens,
        each against its plain version; the joint-major route bitwise equal
        to the slab; the serving and training forwards bitwise equal in
        out."""
        dev = cuda_device()
        model = TemporalLifter(n_blocks=1, clip_len=frames, device="cpu").init_weights(
            torch.Generator().manual_seed(frames))
        model = model.to(device=dev, dtype=torch.bfloat16).eval().requires_grad_(False)
        x = torch.randn(frames * 17, 256, generator=torch.Generator().manual_seed(1)).to(
            dev, torch.bfloat16)
        ws, wt = S.pack_spatial_weights(model.blocks[0]), S.pack_temporal_weights(model.blocks[0])
        got = S.spatial_block(x, ws)
        _rows_close(got.float().cpu(), S.spatial_block_reference(x, ws).float().cpu())
        assert torch.equal(got, ST.spatial_fwd(x, ws)[0])
        slab = x.view(1, frames, -1)
        got = S.temporal_slab(slab, wt)
        _rows_close(got.float().cpu(), S.temporal_slab_reference(slab, wt).float().cpu())
        assert torch.equal(got, ST.slab_fwd(slab, wt)[0])
        jm = S.temporal_block_fused(S.joint_major(x, 1), wt)
        assert torch.equal(jm, S.joint_major(got.view(-1, 256), 1))

    @pytest.mark.parametrize("half", ["spatial", "slab"])
    def test_training_forward_residuals_match_plain(self, half):
        """The kSave forward's out, x1 and att against the plain version's at
        3 clips (12,393 rows, a ragged last tile): rows 5e-2 + 2^-5·|want|."""
        dev = cuda_device()
        model, _, tokens = self._setup(dev, 3)
        blk = model.blocks[0]
        if half == "spatial":
            w, x = S.pack_spatial_weights(blk), tokens
            got, want = ST.spatial_fwd(x, w), ST.spatial_fwd_reference(x, w)
        else:
            w, x = S.pack_temporal_weights(blk), tokens.view(3, model.clip_len, -1)
            got, want = ST.slab_fwd(x, w), ST.slab_fwd_reference(x, w)
        for g, t in zip(got, want):
            assert g.shape == x.shape
            _rows_close(g.float().cpu(), t.float().cpu())

    def test_two_calls_give_the_same_bits(self):
        """No atomics and no order that depends on scheduling: every output
        and residual of both halves, serving and training, twice."""
        dev = cuda_device()
        model, _, tokens = self._setup(dev, 2)
        ws = S.pack_spatial_weights(model.blocks[0])
        wt = S.pack_temporal_weights(model.blocks[0])
        slab = tokens.view(2, model.clip_len, -1)
        for fn, x, w in ((S.spatial_block, tokens, ws), (S.temporal_slab, slab, wt)):
            assert torch.equal(fn(x, w), fn(x, w))
        for fn, x, w in ((ST.spatial_fwd, tokens, ws), (ST.slab_fwd, slab, wt)):
            for a, b in zip(fn(x, w), fn(x, w)):
                assert torch.equal(a, b)

    def test_kernels_reject_f32(self):
        dev = cuda_device()
        model = TemporalLifter(n_blocks=1, device=dev)
        with pytest.raises(TypeError, match="bfloat16"):
            S.spatial_block(torch.zeros(17, 256, device=dev),
                            S.pack_spatial_weights(model.blocks[0]))


def _plain_fused(model, kp):
    """temporal_forward_fused with the trunk in its plain version."""
    tokens = S.embed_clips(model, kp)
    trunk = S.temporal_trunk_reference(tokens, len(kp), S.pack_temporal_lifter(model))
    return S.temporal_head(model, trunk, len(kp))
