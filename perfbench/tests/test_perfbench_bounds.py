"""The frozen work counts, pinned at the cells' shapes: the port's kernel
bounds at B = 8192 and 16 x 243 (0.4479, 0.1063, 0.1217, 0.2745 and
0.3131 ms, the figures of PERF.md's table of kernels) and the two model
flop counts."""

import json

import pytest

from perfbench.harness import bounds
from perfbench.tests.conftest import REPO


def config(name):
    return json.loads((REPO / "perfbench" / "configs" / f"{name}.json").read_text())


def test_trunk_bound_at_the_top_bucket():
    ms, by = bounds.trunk_call_bound(config("vit_lifter"), 8192)
    assert by == "operations"
    assert ms * 1e3 == pytest.approx(0.44786, abs=1e-5)


def test_sub_block_bounds_at_16_clips():
    cfg = config("temporal_lifter")
    fwd, bwd = bounds.sub_block_fwd_bounds(cfg, 16), bounds.sub_block_bwd_bounds(cfg, 16)
    assert {k: round(v[0] * 1e3, 4) for k, v in fwd.items()} == {"spatial": 0.1063,
                                                                  "temporal": 0.1217}
    assert {k: round(v[0] * 1e3, 4) for k, v in bwd.items()} == {"spatial": 0.2745,
                                                                  "temporal": 0.3131}
    assert all(v[1] == "operations" for v in (*fwd.values(), *bwd.values()))


def test_model_flops():
    assert bounds.vit_frame_flops(config("vit_lifter")) == 55_213_824
    assert bounds.temporal_step_flops(config("temporal_lifter"), 16) == 3_396_111_888_384
    assert bounds.temporal_step_flops(config("temporal_lifter"), 16) == \
        3 * bounds.temporal_forward_flops(config("temporal_lifter"), 16)


def test_bound_picks_the_larger_term():
    assert bounds.bound_s(989e12, 0)[1] == "operations"
    assert bounds.bound_s(0, 3.35e12) == (1.0, "bytes")
    assert bounds.bound_s(1, 1, 16 * 132 * 1.98e9 * 2)[1] == "exponentials"
