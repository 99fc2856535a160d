"""The port's TemporalLifter (``pose3d_tpu_torch/models/temporal.py``), its
weight bridge and clip helpers against the JAX package.

Same seeded inputs and flax-initialised weights through the flax module
and the port's ``nn.Module``. Tolerance 1e-4 in f32: both sides compute
exact GELU and a max-subtracted softmax, so what differs is the order of
f32 sums (measured ~1e-6). ``use_kernels=True`` on the CPU runs the
attention kernels' plain versions, whose clamped softmax without a row
max equals the max-subtracted one in f32 to rounding: 1e-5.
"""

import numpy as np
import pytest
import torch

from torch_port_util import flax_apply, flax_temporal, torch_temporal

from pose3d_tpu_torch.models import temporal as T
from pose3d_tpu_torch.ops import attention as A

pytest.importorskip("jax")
torch.set_num_threads(2)

F32_ATOL = 1e-4

CONFIGS = {
    "narrow": {"clip_len": 16, "hidden": 64, "n_blocks": 2, "heads": 4},
    "default_width": {"clip_len": 27, "n_blocks": 2},
    "long_clip": {"clip_len": 70, "hidden": 32, "n_blocks": 1, "heads": 2},
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    fields = CONFIGS[request.param]
    fmodel, params = flax_temporal(seed=0, **fields)
    x = np.random.default_rng(7).random(
        (2, fields["clip_len"], 17, 2)).astype(np.float32)
    return fmodel, params, torch_temporal(params, **fields), x


def test_module_matches_flax_f32(pair):
    fmodel, params, tmodel, x = pair
    want = flax_apply(fmodel, params, x)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_use_kernels_equals_module_on_cpu(pair):
    """The attention wrappers' plain versions (packed for L <= 64, per
    sequence above) in place of the module's softmax."""
    _, _, tmodel, x = pair
    before = (A.packed_flat_attention.launches, A.seq_attention.launches)
    with torch.no_grad():
        plain = tmodel(torch.from_numpy(x))
        kern = tmodel(torch.from_numpy(x), use_kernels=True)
    np.testing.assert_allclose(kern.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    assert (A.packed_flat_attention.launches, A.seq_attention.launches) == before


def test_shorter_clip_matches_flax(pair):
    """Clips shorter than clip_len take the leading temporal PE rows."""
    fmodel, params, tmodel, x = pair
    short = x[:, :9]
    want = flax_apply(fmodel, params, short)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(short))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_bf16_module_close_to_flax_bf16():
    import jax.numpy as jnp

    from pose3d_tpu.models.temporal import TemporalLifter

    fields = CONFIGS["default_width"]
    _, params = flax_temporal(seed=0, **fields)
    x = np.random.default_rng(7).random((2, 27, 17, 2)).astype(np.float32)
    want = flax_apply(TemporalLifter(dtype=jnp.bfloat16, **fields), params, x)
    with torch.no_grad():
        got = torch_temporal(params, dtype=torch.bfloat16, **fields)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=0)


def test_state_dict_covers_the_flax_tree():
    """Every flax leaf lands on a distinct port parameter of its shape."""
    import jax

    from pose3d_tpu_torch.interop.weights import temporal_lifter_from_flax

    _, params = flax_temporal(seed=0, **CONFIGS["narrow"])
    sd = temporal_lifter_from_flax(params)
    assert len(sd) == len(jax.tree.leaves(params))
    model = T.TemporalLifter(**CONFIGS["narrow"], device="cpu")
    assert set(sd) == set(model.state_dict())
    assert sd["blocks.1.temporal_attn.qkv.weight"].shape == (192, 64)
    np.testing.assert_array_equal(
        sd["blocks.1.temporal_mlp.fc2.weight"].numpy(),
        params["SpatioTemporalBlock_1"]["_MLP_1"]["Dense_1"]["kernel"].T)


def test_init_weights_sets_no_default_values():
    model = T.TemporalLifter(clip_len=8, hidden=32, n_blocks=1, heads=2, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        assert not torch.any(p == 0), name
        assert not torch.all(p == 1), name


def test_device_is_required():
    with pytest.raises(TypeError):
        T.TemporalLifter()


def test_too_long_clip_raises():
    model = T.TemporalLifter(clip_len=8, hidden=32, n_blocks=1, heads=2, device="cpu")
    with pytest.raises(ValueError, match="clip_len"):
        model(torch.zeros(1, 9, 17, 2))


@pytest.mark.parametrize("n,clip_len,stride", [
    (438, 243, 121), (40, 27, 13), (100, 25, 25), (10, 16, 16), (243, 243, 121),
    (600, 243, 121), (1, 1, 1)])
def test_clip_starts_and_make_clips_match_jax(n, clip_len, stride):
    from pose3d_tpu.models import temporal as jt

    assert T.clip_starts(n, clip_len, stride) == jt.clip_starts(n, clip_len, stride)
    seq = np.random.default_rng(n).random((n, 17, 2)).astype(np.float32)
    np.testing.assert_array_equal(T.make_clips(seq, clip_len, stride),
                                  jt.make_clips(seq, clip_len, stride))


def test_every_frame_covered():
    """The 438/243/121 case: the stride grid stops at 121, and the tail
    anchor at 195 covers frames 364..437."""
    starts = T.clip_starts(438, 243, 121)
    assert starts == [0, 121, 195]
    covered = np.zeros(438, bool)
    for s in starts:
        covered[s:s + 243] = True
    assert covered.all()
