"""The numbers that decide ``correct``, each a gap between the program's
reading and the plain reference's."""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3  # a leaf whose reference gradient is under this share of the median's


def output_gaps(outs, refs) -> dict[str, float]:
    """Served poses against the reference's: the widest gap of any
    coordinate, and the root-mean-square gap over every coordinate."""
    widest, num, count = 0.0, 0.0, 0
    for o, r in zip(outs, refs):
        diff = o.double() - r.double()
        if diff.numel():
            widest = max(widest, float(diff.abs().max()))
        num += float(diff.square().sum())
        count += diff.numel()
    if any(not torch.isfinite(o).all() for o in outs) or not count:
        return {"max_abs_err": float("inf"), "rms_err": float("inf")}
    return {"max_abs_err": widest, "rms_err": (num / count) ** 0.5}


def kept_leaves(ref_grad_norms: dict[str, float]) -> list[str]:
    """Leaves whose reference gradient is above NEGLIGIBLE of the median
    leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= NEGLIGIBLE * med]


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], keep) -> dict[str, float]:
    """Each kept leaf's gap between the program's norm and the
    reference's, over the larger of the reference leaf's norm and the
    median leaf's."""
    med = statistics.median(ref[k] for k in keep)
    out = {}
    for k in keep:
        p = prog.get(k, 0.0)
        out[k] = abs(p - ref[k]) / max(ref[k], med) if p == p else float("inf")
    return out


def leaf_diffs(prog: dict, ref: dict, ref_norms: dict[str, float], keep) -> dict[str, float]:
    """Each kept leaf's norm of its difference from the reference's leaf,
    over the larger of the reference leaf's norm and the median leaf's.
    Unlike a gap of norms, it reads unbiased rounding noise in the first
    order."""
    med = statistics.median(ref_norms[k] for k in keep)
    out = {}
    for k in keep:
        d = float((prog[k].double() - ref[k].double()).norm()) / max(ref_norms[k], med)
        out[k] = d if d == d else float("inf")
    return out


def rel_gaps(prog: list, ref: list) -> list[float]:
    return [abs(p - r) / abs(r) if p == p else float("inf") for p, r in zip(prog, ref)]


def train_gaps(prog: tuple, ref: tuple, ref_bf16: tuple) -> dict[str, float]:
    """Each argument: ({"losses": [...], "mpjpe": [...], "grad": {leaf:
    norm}, "update": {leaf: norm}}, {leaf: first gradient}); ``ref`` the
    float32 reference's, ``ref_bf16`` the reference's in bfloat16 products.
    Compared, each by its worst leaf: the first gradient's gap of norms;
    the norm of its difference over that of the bfloat16 reference (how
    many times the gap that the configuration's precision explains: the
    seed's gradient scale, which sets how far rounding reaches, cancels);
    the gap of norms of the change after the steps. And the first step's
    relative gap of the MPJPE sum (its per-joint L2 errors summed over the
    batch). Read beside them: the difference itself, the worst step's
    MPJPE and loss gaps, and the first step's loss gap, which Adam's first
    moves and the seed's sensitivity to bf16 inputs swing too far to
    separate (PERF.md section 2)."""
    (prog, prog_grad), (ref, ref_grad), (_, bf16_grad) = prog, ref, ref_bf16
    keep = kept_leaves(ref["grad"])
    losses, mpjpe = rel_gaps(prog["losses"], ref["losses"]), rel_gaps(prog["mpjpe"], ref["mpjpe"])
    diff = max(leaf_diffs(prog_grad, ref_grad, ref["grad"], keep).values())
    scale = max(leaf_diffs(bf16_grad, ref_grad, ref["grad"], keep).values())
    return {"grad_gap": max(leaf_gaps(prog["grad"], ref["grad"], keep).values()),
            "grad_diff_vs_bf16": diff / scale if scale > 0 else float("inf"),
            "update_gap": max(leaf_gaps(prog["update"], ref["update"], keep).values()),
            "mpjpe_gap": mpjpe[0], "grad_diff": diff, "mpjpe_gap_steps": max(mpjpe),
            "loss_gap": max(losses), "loss_gap_1": losses[0]}
