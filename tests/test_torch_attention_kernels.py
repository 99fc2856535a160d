"""The port's attention wrappers (``pose3d_tpu_torch/ops/attention.py``:
``packed_flat_attention``, ``seq_attention``) against the JAX package's
Pallas kernels in interpret mode, and the CUDA kernels (``attention_kernel``
at L <= SPLIT_LEN, ``attention_wg_kernel`` above it) against their plain
version on the card.

Tolerances. f32 inputs: 1e-5, the same expression with f32 sums in
another order (outputs are averages of N(0, 1) values). bf16 plain
versions: 2^-7 relative to the output (one bf16 step) plus 1e-3: both
sides round e and the output to bf16 once, at the same points, and their
f32 score sums run in the same order. The CUDA kernel sums its scores on
the tensor cores, in another order, which can flip the bf16 rounding of
a dominant softmax numerator: worth 2^-8 |v|, with |v| up to ~4 for
N(0, 1) inputs, so it is held to 2^-6 + 2^-7 |want|.

The tests marked ``cuda`` skip where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device

from pose3d_tpu_torch.ops import attention as A

torch.set_num_threads(2)

# (heads, dh): the temporal lifter's 8 x 32, the narrow configs' 4 x 16
# (hidden 64) and 2 x 32, and the default lifter's 4 x 64
HEAD_SHAPES = [(8, 32), (4, 16), (2, 32), (4, 64)]


def _qkv(shape, heads, dh, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (*shape, 3 * heads * dh)).astype(np.float32)


def _bf16_close(got, want, atol=1e-3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    excess = np.abs(got - want) - (atol + 2 ** -7 * np.abs(want))
    assert excess.max() <= 0, f"max abs err {np.abs(got - want).max():.3g}"


class TestPackedAgainstJax:
    # n_seqs * seq is never a multiple of the JAX kernel's cell, so the
    # JAX side pads with zero sequences; seq 40 and 5 are not multiples of 16
    @pytest.mark.parametrize("seq,n_seqs", [(17, 9), (40, 3), (5, 7)])
    @pytest.mark.parametrize("heads,dh", HEAD_SHAPES)
    def test_f32_matches_jax_kernel(self, seq, n_seqs, heads, dh):
        import jax.numpy as jnp

        from pose3d_tpu.ops.pallas_attention import packed_flat_attention

        qkv = _qkv((n_seqs * seq,), heads, dh, seed=seq)
        want = np.asarray(packed_flat_attention(jnp.asarray(qkv), seq, heads, True))
        got = A.packed_flat_attention(torch.from_numpy(qkv), seq, heads)
        assert got.shape == (n_seqs * seq, heads * dh) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)

    def test_bf16_matches_jax_kernel(self):
        import jax.numpy as jnp

        from pose3d_tpu.ops.pallas_attention import packed_flat_attention

        qkv = torch.from_numpy(_qkv((17 * 6,), 8, 32, seed=1)).to(torch.bfloat16)
        want = packed_flat_attention(jnp.asarray(qkv.float().numpy(), jnp.bfloat16),
                                     17, 8, True)
        got = A.packed_flat_attention(qkv, 17, 8)
        assert got.dtype == torch.bfloat16
        _bf16_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


class TestSeqAgainstJax:
    # 65 and 257: one row past a 64-row and a 256-row tile of the CUDA
    # kernel for L > 64
    @pytest.mark.parametrize("length", [100, 243, 70, 65, 257])
    @pytest.mark.parametrize("heads,dh", HEAD_SHAPES)
    def test_f32_matches_jax_kernel(self, length, heads, dh):
        import jax.numpy as jnp

        from pose3d_tpu.ops.pallas_attention import seq_attention

        qkv = _qkv((3, length), heads, dh, seed=length)
        want = np.asarray(seq_attention(jnp.asarray(qkv), heads, True))
        got = A.seq_attention(torch.from_numpy(qkv), heads)
        assert got.shape == (3, length, heads * dh)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)

    def test_bf16_matches_jax_kernel(self):
        import jax.numpy as jnp

        from pose3d_tpu.ops.pallas_attention import seq_attention

        qkv = torch.from_numpy(_qkv((2, 243), 8, 32, seed=2)).to(torch.bfloat16)
        want = seq_attention(jnp.asarray(qkv.float().numpy(), jnp.bfloat16), 8, True)
        _bf16_close(A.seq_attention(qkv, 8).float().numpy(),
                    np.asarray(want.astype(jnp.float32)))


class TestWrappers:
    def test_zero_sequence_gives_zero(self):
        """An all-zero sequence (the JAX kernels' row padding) attends
        uniformly over zero values: zero output, and its neighbours'
        outputs do not move."""
        qkv = torch.from_numpy(_qkv((3 * 17,), 8, 32))
        padded = torch.cat([qkv, torch.zeros(17, qkv.shape[1])])
        out = A.packed_flat_attention(padded, 17, 8)
        assert torch.equal(out[3 * 17:], torch.zeros(17, 256))
        assert torch.equal(out[:3 * 17], A.packed_flat_attention(qkv, 17, 8))

    def test_packed_equals_seq_on_the_same_bytes(self):
        qkv = torch.from_numpy(_qkv((4, 17), 8, 32))
        flat = A.packed_flat_attention(qkv.view(4 * 17, -1), 17, 8)
        assert torch.equal(flat.view(4, 17, -1), A.seq_attention(qkv, 8))

    def test_cpu_runs_the_plain_version(self):
        qkv = torch.from_numpy(_qkv((2, 17), 8, 32))
        before = (A.packed_flat_attention.launches, A.seq_attention.launches)
        assert torch.equal(A.seq_attention(qkv, 8), A.seq_attention_reference(qkv, 8))
        assert torch.equal(A.packed_flat_attention(qkv.view(34, -1), 17, 8),
                           A.packed_flat_attention_reference(qkv.view(34, -1), 17, 8))
        assert (A.packed_flat_attention.launches, A.seq_attention.launches) == before

    @pytest.mark.parametrize("case", ["partial", "width", "rank", "heads"])
    def test_rejects_bad_operands(self, case):
        qkv = torch.zeros(34, 768)
        if case == "partial":
            with pytest.raises(ValueError, match="whole sequences"):
                A.packed_flat_attention(qkv[:30], 17, 8)
        elif case == "width":
            with pytest.raises(ValueError, match="heads"):
                A.packed_flat_attention(torch.zeros(34, 100), 17, 8)
        elif case == "rank":
            with pytest.raises(ValueError, match=r"\(N, L"):
                A.seq_attention(qkv, 8)
        else:
            with pytest.raises(ValueError, match="heads"):
                A.seq_attention(qkv.view(2, 17, 768), 7)

    def test_smem_bytes_fits_the_lifter_shapes(self):
        assert A.smem_bytes(243, 32) <= A.SMEM_LIMIT
        assert A.smem_bytes(243, 64) <= A.SMEM_LIMIT
        assert A.smem_bytes(5000, 64) > A.SMEM_LIMIT

    def test_smem_bytes_holds_k_and_v_only(self):
        # Q stays in registers: K and V of one head, rows padded to 16, pitch dh + 8
        assert A.smem_bytes(243, 32) == 2 * 256 * 40 * 2
        assert A.smem_bytes(17, 32) == 2 * 32 * 40 * 2
        assert A.smem_bytes(1, 64) == 2 * 16 * 72 * 2

    # the longest L each head width's K and V leave in 232,448 bytes
    @pytest.mark.parametrize("dh,limit", [(16, 2416), (32, 1440), (64, 800)])
    def test_length_limit(self, dh, limit):
        A.check_length(limit, dh)
        with pytest.raises(ValueError, match="do not fit in shared memory"):
            A.check_length(limit + 1, dh)


@pytest.mark.cuda
class TestAttentionKernel:
    """The CUDA kernel against its plain version on the card, bf16."""

    @pytest.mark.parametrize("seq", [17, 40, 5])
    @pytest.mark.parametrize("heads,dh", [(8, 32), (4, 16), (4, 64)])
    def test_packed_kernel_matches_plain(self, seq, heads, dh):
        dev = cuda_device()
        qkv = torch.from_numpy(_qkv((33 * seq,), heads, dh, seed=seq)).to(dev, torch.bfloat16)
        before = A.packed_flat_attention.launches
        got = A.packed_flat_attention(qkv, seq, heads)
        torch.cuda.synchronize()
        assert A.packed_flat_attention.launches == before + 1
        _bf16_close(got.float().cpu().numpy(),
                    A.packed_flat_attention_reference(qkv, seq, heads).float().cpu().numpy(),
                    atol=2 ** -6)

    # the wgmma kernel's edges (L > SPLIT_LEN): one row past the split,
    # whole and ragged 128-row query and key tiles, and the main path's 243
    @pytest.mark.parametrize("length", [65, 100, 128, 129, 243, 256, 257])
    @pytest.mark.parametrize("heads,dh", [(8, 32), (4, 16), (4, 64)])
    def test_seq_kernel_matches_plain(self, length, heads, dh):
        dev = cuda_device()
        qkv = torch.from_numpy(_qkv((5, length), heads, dh, seed=length)).to(dev, torch.bfloat16)
        before = A.seq_attention.launches
        got = A.seq_attention(qkv, heads)
        again = A.seq_attention(qkv, heads)
        torch.cuda.synchronize()
        assert A.seq_attention.launches == before + 2
        assert torch.equal(got, again)
        _bf16_close(got.float().cpu().numpy(),
                    A.seq_attention_reference(qkv, heads).float().cpu().numpy(),
                    atol=2 ** -6)

    def test_kernel_isolates_sequences(self):
        dev = cuda_device()
        qkv = torch.from_numpy(_qkv((8 * 17,), 8, 32)).to(dev, torch.bfloat16)
        base = A.packed_flat_attention(qkv, 17, 8)
        pert = qkv.clone()
        pert[:17] += 1.0
        out = A.packed_flat_attention(pert, 17, 8)
        assert torch.equal(base[17:], out[17:])
        assert not torch.equal(base[:17], out[:17])

    # the longest L check_length lets each head width have
    @pytest.mark.parametrize("heads,dh,limit", [(8, 32, 1440), (4, 16, 2416), (4, 64, 800)])
    def test_seq_kernel_takes_the_longest_sequence(self, heads, dh, limit):
        dev = cuda_device()
        qkv = torch.from_numpy(_qkv((2, limit), heads, dh, seed=3)).to(dev, torch.bfloat16)
        got = A.seq_attention(qkv, heads)
        assert torch.equal(got, A.seq_attention(qkv, heads))
        _bf16_close(got.float().cpu().numpy(),
                    A.seq_attention_reference(qkv, heads).float().cpu().numpy(), atol=2 ** -6)
        with pytest.raises(ValueError, match="do not fit in shared memory"):
            A.seq_attention(torch.zeros(1, limit + 1, 3 * heads * dh, device=dev,
                                        dtype=torch.bfloat16), heads)

    def test_split_between_the_two_kernels(self):
        """L = SPLIT_LEN and SPLIT_LEN + 1 through both wrappers: the
        packed form of the same bytes gives the same bits either side of
        the split, one launch a call."""
        dev = cuda_device()
        for length in (A.SPLIT_LEN, A.SPLIT_LEN + 1):
            qkv = torch.from_numpy(_qkv((7, length), 8, 32, seed=length)).to(dev, torch.bfloat16)
            before = (A.packed_flat_attention.launches, A.seq_attention.launches)
            got = A.seq_attention(qkv, 8)
            flat = A.packed_flat_attention(qkv.view(7 * length, -1), length, 8)
            torch.cuda.synchronize()
            assert (A.packed_flat_attention.launches, A.seq_attention.launches) == (
                before[0] + 1, before[1] + 1)
            assert torch.equal(flat.view_as(got), got)
            _bf16_close(got.float().cpu().numpy(),
                        A.seq_attention_reference(qkv, 8).float().cpu().numpy(), atol=2 ** -6)

    def test_kernel_rejects_other_head_widths(self):
        dev = cuda_device()
        with pytest.raises(ValueError, match="head width"):
            A.seq_attention(torch.zeros(2, 17, 3 * 8 * 24, device=dev,
                                        dtype=torch.bfloat16), 8)
        with pytest.raises(TypeError, match="bfloat16"):
            A.seq_attention(torch.zeros(2, 17, 768, device=dev), 8)
