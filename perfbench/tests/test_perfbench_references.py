"""The plain references against the port's float32 modules and step, at
small sizes on the CPU (the port's modules compute the same equations:
exact GELU, a max-subtracted softmax, float32 throughout)."""

import json

import numpy as np
import pytest
import torch

from perfbench.harness.weights import seeded_params
from perfbench.references import temporal_lifter as tref
from perfbench.references import vit_lifter as vref
from perfbench.tests.conftest import REPO
from pose3d_tpu_torch.models.lifters import JointTransformerLifter
from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.serving import LifterService
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.steps import make_lifter_train_step


def config(name: str, **over) -> dict:
    cfg = json.loads((REPO / "perfbench" / "configs" / f"{name}.json").read_text())
    cfg.update(over)
    return cfg


def keypoints(n: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).uniform(0.2, 0.8, (n, 17, 2))
                            .astype(np.float32))


def test_vit_forward_matches_the_module():
    cfg = config("vit_lifter")
    params = seeded_params(vref.param_shapes(cfg), 3, "cpu")
    model = JointTransformerLifter(device="cpu")
    model.load_state_dict(params, strict=True)
    x = keypoints(24, 1)
    with torch.no_grad():
        want = model(x)
    got = vref.forward(params, x, cfg)
    assert torch.allclose(got, want, atol=1e-4, rtol=0), float((got - want).abs().max())


@pytest.mark.parametrize("n", [1, 7, 8, 9, 20, 33])
def test_vit_serving_rules_match_the_service(n):
    cfg = config("vit_lifter", max_batch=16, min_bucket=4)
    params = seeded_params(vref.param_shapes(cfg), 5, "cpu")
    svc = LifterService(JointTransformerLifter(device="cpu"), params, device="cpu",
                        max_batch=16, min_bucket=4)
    assert vref.buckets(cfg) == svc.buckets
    x = keypoints(n, n)
    got = vref.serve(params, x, cfg)
    assert got.shape == (n, 17, 3)
    assert torch.allclose(got, vref.forward(params, x, cfg), atol=1e-5, rtol=0)
    want = svc.lift(x.numpy())
    assert np.abs(got.numpy() - want).max() < 1e-4
    sizes = [take for take, _ in vref.chunk_buckets(n, cfg)]
    assert sum(sizes) == n and all(s <= 16 for s in sizes)


def test_temporal_forward_matches_the_module():
    cfg = config("temporal_lifter", n_blocks=2, clip_len=12)
    params = seeded_params(tref.param_shapes(cfg), 4, "cpu")
    model = TemporalLifter(n_blocks=2, clip_len=12, device="cpu")
    model.load_state_dict(params, strict=True)
    clips = keypoints(2 * 12, 2).view(2, 12, 17, 2)
    with torch.no_grad():
        want = model(clips)
    got = tref.forward(params, clips, cfg)
    assert torch.allclose(got, want, atol=1e-4, rtol=0), float((got - want).abs().max())


def test_temporal_steps_match_the_port_step():
    """Three AdamW steps of the reference against the port's train step on
    its module route, float32, from the same weights and batches."""
    cfg = config("temporal_lifter", n_blocks=1, clip_len=12)
    params = seeded_params(tref.param_shapes(cfg), 6, "cpu")
    model = TemporalLifter(n_blocks=1, clip_len=12, device="cpu")
    model.load_state_dict(params, strict=True)
    state = create_train_state(model, lr=cfg["lr"], weight_decay=cfg["weight_decay"])
    step = make_lifter_train_step("mse")
    gen = torch.Generator().manual_seed(0)
    batches = [(torch.rand(2, 12, 17, 2, generator=gen), torch.randn(2, 12, 17, 3, generator=gen))
               for _ in range(3)]
    losses = [float(step(state, a, b)["loss"]) for a, b in batches]
    ref_losses, _, ref_params, _ = tref.train_steps(params, batches, cfg)
    assert np.allclose(losses, ref_losses, rtol=1e-5, atol=0)
    for name, p in model.named_parameters():
        # Adam's step is lr g / |g| where |g| is near eps: there the sign of a
        # round-off decides a move of up to lr, as for a key bias
        assert torch.allclose(p.detach(), ref_params[name], atol=2 * cfg["lr"] * 3 + 1e-6), name
    moved = [float((p.detach() - params[n]).abs().max()) for n, p in model.named_parameters()]
    assert min(moved) > 0


def test_leaves_split_qkv():
    t = {"blocks.0.spatial_attn.qkv.bias": torch.arange(6.0), "norm.weight": torch.ones(2)}
    leaves = tref.leaves(t)
    assert sorted(leaves) == ["blocks.0.spatial_attn.qkv.bias[k]",
                              "blocks.0.spatial_attn.qkv.bias[q]",
                              "blocks.0.spatial_attn.qkv.bias[v]", "norm.weight"]
    assert leaves["blocks.0.spatial_attn.qkv.bias[k]"].tolist() == [2.0, 3.0]


def test_temporal_steps_in_chunks_are_the_whole_batch(monkeypatch):
    """A batch run CHUNK_CLIPS clips at a time gives the whole batch's
    loss, gradient, parameters and MPJPE sum."""
    cfg = config("temporal_lifter", n_blocks=1, clip_len=6)
    params = seeded_params(tref.param_shapes(cfg), 8, "cpu")
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.rand(5, 6, 17, 2, generator=gen), torch.randn(5, 6, 17, 3, generator=gen))
               for _ in range(2)]
    monkeypatch.setattr(tref, "CHUNK_CLIPS", 2)
    chunked = tref.train_steps(params, batches, cfg)
    monkeypatch.setattr(tref, "CHUNK_CLIPS", 5)
    whole = tref.train_steps(params, batches, cfg)
    assert np.allclose(chunked[0], whole[0], rtol=1e-6)
    assert np.allclose(chunked[3], whole[3], rtol=1e-6)
    for name in params:
        assert torch.allclose(chunked[1][name], whole[1][name], rtol=1e-4, atol=1e-7), name
        # Adam turns a key weight's or bias's round-off gradient into moves of lr
        assert torch.allclose(chunked[2][name], whole[2][name], atol=2 * cfg["lr"] * 2 + 1e-6), \
            name
