"""DSTformer's fused sub-blocks (``ops/dstformer.py``, ``csrc/dstformer.cu``):
their plain versions against ``DSTBlock``'s module route on the CPU, the
route's predicate and counters, the wrapper's refusals; and, on the card
(``cuda`` marker), each launch against its plain version.

- The plain sub-block on frame-major rows equals ``DSTBlock._sub_block``
  (the module route, the temporal axis between its transposes) for both
  axes and both stream orders in f32 to 1e-4; in bf16, with three
  roundings of a product fewer, it lies nearer the f32 answer.
- ``takes_fused`` picks the fused route for a bf16 DSTformer at the
  published widths on a CUDA device, and for nothing else.
- A forward on the fused route counts 20 sub-blocks and answers nearer
  the f32 model than the module route.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pose3d_tpu_torch.models.dstformer import DSTformer
from pose3d_tpu_torch.ops import attention
from pose3d_tpu_torch.ops import dstformer as fused
from pose3d_tpu_torch.pipeline.lift import lift_sequence

SMALL = dict(n_joints=17, in_dim=3, out_dim=3, clip_len=27, hidden=64, rep_dim=64, n_blocks=2,
             heads=4, mlp_ratio=2, ln_eps=1e-6)
# f32 on both sides, the attention's sums in other orders
ATOL = 1e-4


def small_model(dtype=torch.float32, seed=0, **kw) -> DSTformer:
    return DSTformer(**{**SMALL, **kw}, device="cpu", dtype=dtype).init_weights(
        torch.Generator().manual_seed(seed))


def tokens(clips, frames, width, dtype, seed=1) -> torch.Tensor:
    """(clips, frames, 17, width) tokens of unit scale."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(clips, frames, 17, width, generator=gen).to(dtype)


def module_sub_block(block, axis, x, use_kernels=True):
    """``DSTBlock``'s own route for one sub-block on (B, T, J, C) tokens."""
    b, t, j, c = x.shape
    if axis == "s":
        return block._sub_block("s", x.reshape(b * t, j, c), use_kernels).view(b, t, j, c)
    xt = x.transpose(1, 2).reshape(b * j, t, c)
    return block._sub_block("t", xt, use_kernels).view(b, j, t, c).transpose(1, 2)


CASES = [(order, axis) for order in ("st", "ts") for axis in ("s", "t")]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("order, axis", CASES)
def test_plain_sub_block_is_the_module_route_in_f32(order, axis, use_kernels):
    m = small_model()
    block = m.blocks_st[1] if order == "st" else m.blocks_ts[1]
    assert block.order == order
    x = tokens(2, 27, 64, torch.float32)
    with torch.no_grad():
        want = module_sub_block(block, axis, x, use_kernels)
        got = fused.sub_block_reference(x.reshape(-1, 64), fused.weights(block, axis), axis, 27,
                                        heads=4)
    assert float(want.abs().max()) > 1
    torch.testing.assert_close(got.view_as(x), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("order, axis", CASES)
def test_plain_sub_block_rounds_where_the_bf16_module_route_rounds(order, axis):
    """bf16 on both sides: the plain sub-block rounds each LayerNorm and
    each launch's output where the module route rounds them, and keeps the
    fc1, proj and fc2 products unrounded into the GELU and the residual
    adds, where the module route rounds them too. So its answer lies nearer
    the f32 answer of the same bf16 inputs and weights: by rms, and at no
    element farther than the module route's widest gap."""
    m = small_model(torch.bfloat16, seed=2)
    block = m.blocks_st[0] if order == "st" else m.blocks_ts[0]
    x = tokens(2, 27, 64, torch.bfloat16, seed=3)
    w = fused.weights(block, axis)
    with torch.no_grad():
        want = module_sub_block(block, axis, x)
        got = fused.sub_block_reference(x.reshape(-1, 64), w, axis, 27, heads=4).view_as(x)
        exact = fused.sub_block_reference(x.reshape(-1, 64).float(),
                                          fused.SubBlockWeights(*(t.float() for t in w)), axis,
                                          27, heads=4).view_as(x)
    assert got.dtype == torch.bfloat16
    rms = {k: float((v.float() - exact).square().mean().sqrt())
           for k, v in (("plain", got), ("module", want))}
    assert rms["plain"] < 0.95 * rms["module"], rms
    assert float((got.float() - exact).abs().max()) <= float((want.float() - exact).abs().max())


def test_temporal_sub_block_reads_frame_major_rows_in_place():
    """The temporal sub-block of the fused route takes the (clip, frame,
    joint) rows as they lie, with no transposed copy, and gives frame-major
    rows back: the module route's answer."""
    m = small_model(seed=4, heads=fused.HEADS)
    block = m.blocks_ts[0]
    x = tokens(3, 27, 64, torch.float32, seed=5)
    rows = x.reshape(-1, 64)
    w = fused.weights(block, "t")
    qkv = fused.ln_qkv(rows, w)
    o = fused.attend(qkv, "t", 27)
    # each joint's frames attend to each other only: frame-major rows of
    # the same (clip, joint) sequence
    seqs = qkv.view(3, 27, 17, -1).transpose(1, 2)
    want_o = attention.heads_attention(seqs, 8, 8).transpose(1, 2).reshape(-1, 64)
    torch.testing.assert_close(o, want_o, atol=1e-6, rtol=0)
    with torch.no_grad():
        got = fused.sub_block(rows, w, "t", 27).view_as(x)
        want = module_sub_block(block, "t", x)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert rows.data_ptr() == x.data_ptr()  # x untouched, no copy of it made


@pytest.mark.parametrize("frames", [27, 5])
def test_a_blocks_fused_route_equals_its_module_route(frames):
    m = small_model(seed=6, heads=fused.HEADS)  # the fused route's heads, at width 64
    x = tokens(2, frames, 64, torch.float32, seed=7)
    with torch.no_grad():
        for block in (m.blocks_st[0], m.blocks_ts[1]):
            torch.testing.assert_close(block.forward_fused(x), block(x, True), atol=ATOL, rtol=0)


# ------------------------------------------------------------ the route


def fake_tokens(device="cuda", dtype=torch.bfloat16):
    """What the predicate reads of the tokens, without a card."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.fixture(scope="module")
def published():
    return DSTformer(device="meta", dtype=torch.bfloat16)


def test_the_predicate_takes_the_published_widths_in_bf16_on_a_card(published):
    assert fused.supports(published)
    with torch.no_grad():
        assert fused.takes_fused(published, fake_tokens(), True)
        assert not fused.takes_fused(published, fake_tokens(), False)
        assert not fused.takes_fused(published, fake_tokens("cpu"), True)
        assert not fused.takes_fused(published, fake_tokens(dtype=torch.float32), True)
    with torch.enable_grad():  # the launches have no backward
        assert not fused.takes_fused(published, fake_tokens(), True)


@pytest.mark.parametrize("other", [dict(hidden=256, rep_dim=256), dict(heads=4),
                                   dict(mlp_ratio=4), dict(ln_eps=1e-5), dict(n_joints=16)],
                         ids=lambda d: ",".join(d))
def test_the_predicate_refuses_other_widths(other):
    m = DSTformer(**other, device="meta", dtype=torch.bfloat16)
    with torch.no_grad():
        assert not fused.supports(m)
        assert not fused.takes_fused(m, fake_tokens(), True)


def test_a_forward_on_the_fused_route_counts_20_sub_blocks(monkeypatch):
    """The published DSTformer, its route forced on the CPU (where the
    launches run their plain versions): 2 streams x 5 blocks x 2
    sub-blocks, every one through ``ops.dstformer.sub_block``; the answer
    is the model's, by rms nearer the f32 model's than the module route's
    (its sub-blocks round three products fewer)."""
    monkeypatch.setattr(fused, "takes_fused", lambda m, x, k: k and fused.supports(m))
    m = DSTformer(device="cpu", dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(8))
    x = torch.rand(1, 3, 17, 3, generator=torch.Generator().manual_seed(9))
    before = fused.sub_block.fused, fused.sub_block.launches
    with torch.no_grad():
        got = m(x, use_kernels=True)
        assert (fused.sub_block.fused - before[0], fused.sub_block.launches - before[1]) == (20, 0)
        monkeypatch.undo()
        want = m(x, use_kernels=True)  # the module route on the same attention
        exact = copy.deepcopy(m).to(torch.float32)(x, use_kernels=True)
    assert fused.sub_block.fused - before[0] == 20
    assert got.shape == (1, 3, 17, 3) and torch.isfinite(got).all()
    # rms nearer; the widest gap, one element of 153 that the CPU's thread
    # count moves, within the port's 1.5x of the module route's
    gaps = {k: (v.float() - exact).abs() for k, v in (("fused", got), ("module", want))}
    assert float(gaps["fused"].square().mean()) < float(gaps["module"].square().mean()), gaps
    assert float(gaps["fused"].max()) <= 1.5 * float(gaps["module"].max()), gaps


def test_small_models_keep_the_module_route():
    m = small_model(torch.bfloat16, seed=10)
    before = fused.sub_block.fused
    kp = np.random.default_rng(0).uniform(0, 1000, (40, 17, 3)).astype(np.float32)
    lift_sequence(m, kp)
    assert fused.sub_block.fused == before


# ------------------------------------------------------------ refusals


def operands(width=512, rows=2 * 17 * 4, dtype=torch.bfloat16):
    x = torch.zeros(rows, width, dtype=dtype)
    m = DSTformer(device="cpu", dtype=dtype, n_blocks=1, hidden=width, rep_dim=width,
                  heads=max(1, width // 64))
    return x, fused.weights(m.blocks_st[0], "s")


def test_the_kernels_operands_pass_their_check():
    fused.check_operands(*operands(), frames=4)


@pytest.mark.parametrize("fault, error", [
    ("width", ValueError), ("dtype", TypeError), ("layout", ValueError), ("clips", ValueError),
    ("weight", ValueError), ("weight_dtype", TypeError)])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(fault, error):
    x, w = operands(width=256) if fault == "width" else operands()
    frames = 4
    if fault == "dtype":
        x = x.float()
    elif fault == "layout":
        x = torch.zeros(512, x.shape[0], dtype=x.dtype).t()  # (rows, 512), not contiguous
    elif fault == "clips":
        frames = 5
    elif fault == "weight":
        w = w._replace(fc1_w=w.fc1_w[:, :256])
    elif fault == "weight_dtype":
        w = w._replace(qkv_b=w.qkv_b.float())
    with pytest.raises(error):
        fused.check_operands(x, w, frames)


def test_the_wrapper_refuses_an_unknown_axis():
    x, w = operands()
    with pytest.raises(ValueError, match="axis"):
        fused.sub_block(x, w, "j", 4)
    with pytest.raises(ValueError, match="axis"):
        fused.attend(torch.zeros(68, 1536), "x", 4)


# ------------------------------------------------------------ on the card

CARD_CASES = [(clips, frames, order, axis)
              for clips, frames in ((1, 243), (3, 243), (16, 243), (2, 40))
              for order, axis in CASES]


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    m = DSTformer(device="cpu").init_weights(torch.Generator().manual_seed(11))
    return m.to("cuda", torch.bfloat16).eval(), m.to("cuda").eval()


def card_rows(model, clips, frames, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(clips, frames, 17, 3, generator=gen).to("cuda", model.dtype)
    h = model.joints_embed(x) + model.pos_embed + model.temp_embed[:, :frames]
    return h.reshape(-1, 512).contiguous()


def close(got, want, atol, rtol):
    """Kernel against plain bf16: the sums' order flips bf16 roundings."""
    excess = (got.float() - want.float()).abs() - (atol + rtol * want.float().abs())
    return bool(torch.isfinite(got).all()) and float(excess.max()) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("clips, frames, order, axis", CARD_CASES)
def test_each_launch_matches_its_plain_version_on_the_card(card_model, clips, frames, order,
                                                           axis):
    """1 clip (4,131 rows), 3 clips (12,393) and 16 (66,096: ~4 row tiles
    a CTA of the persistent products, which reload A from the second tile
    on), rows no multiple of either tile, and 2 clips of 40 frames (the
    temporal attention at L <= 64):
    each launch on the plain version's inputs, within chip_smoke's limits
    (rows 5e-2 + 2^-5 |want|, the attention 2^-6 + 2^-7 |want|); two calls
    of the whole sub-block give the same bits."""
    model, _ = card_model
    block = model.blocks_st[0] if order == "st" else model.blocks_ts[0]
    w = fused.weights(block, axis)
    with torch.inference_mode():
        x = card_rows(model, clips, frames, 12 + clips)
        qkv = fused.ln_qkv_reference(x, w)
        o = fused.attend_reference(qkv, axis, frames)
        x1 = fused.proj_residual_reference(o, w, x)
        h = fused.ln_fc1_gelu_reference(x1, w)
        pairs = {"ln_qkv": (fused.ln_qkv(x, w), qkv),
                 "attend": (fused.attend(qkv, axis, frames), o),
                 "proj_residual": (fused.proj_residual(o, w, x), x1),
                 "ln_fc1_gelu": (fused.ln_fc1_gelu(x1, w), h),
                 "fc2_residual": (fused.fc2_residual(h, w, x1),
                                  fused.fc2_residual_reference(h, w, x1))}
        for name, (got, want) in pairs.items():
            atol, rtol = (2 ** -6, 2 ** -7) if name == "attend" else (5e-2, 2 ** -5)
            assert close(got, want, atol, rtol), name
        out = fused.sub_block(x, w, axis, frames)
        assert torch.equal(out, fused.sub_block(x, w, axis, frames))
        assert close(out, fused.sub_block_reference(x, w, axis, frames), 5e-2, 2 ** -5)


@pytest.mark.cuda
def test_a_video_on_the_fused_route_matches_the_module_route_on_the_card(card_model):
    """600 frames (5 clips of 243), chip_smoke's dstformer_phase: every
    sub-block on the fused launches; the answer's rms gap to the f32 model
    at most 1.5x the plain bf16 route's."""
    model, model32 = card_model
    rng = np.random.default_rng(13)
    kp = np.concatenate([rng.random((600, 17, 2)) * 1000, rng.uniform(0.3, 1.0, (600, 17, 1))],
                        -1).astype(np.float32)
    before = fused.sub_block.fused, fused.sub_block.launches
    got = lift_sequence(model, kp)
    assert (fused.sub_block.fused - before[0], fused.sub_block.launches - before[1]) == (20, 100)
    plain = lift_sequence(model, kp, use_kernels=False)
    want = lift_sequence(model32, kp)
    rms = {k: float(np.sqrt(((v - want) ** 2).mean())) for k, v in (("kernels", got),
                                                                       ("plain", plain))}
    assert rms["kernels"] <= 1.5 * rms["plain"], rms
