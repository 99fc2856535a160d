"""The yardstick's work counts: peaks of one H100 and the least time a
call could take, from its shapes alone.

Frozen copies of the bound formulas the port's kernel checks used
(``bound``, ``launch_bound``, ``kernel_bounds`` of the repository's chip
script): a call's matrix-product flops over the bf16 peak, each input
byte read once and each output byte written once over the HBM rate, and
for attention one exponential a score over the SFUs. The bound reads the
same work whatever implements it, so a later change to the program moves
only the time it is divided by.

The model flop counts (``vit_frame_flops``, ``temporal_step_flops``)
count the products of a forward from the widths: 2 flops a
multiply-add, the attention's two (L x L x dh) products a head, the
embed and the head; LayerNorm, GELU and softmax arithmetic are left out.
A training step is 3 forwards (the forward, and the backward's two
products a forward product).
"""

from __future__ import annotations

PEAK_BF16 = 989e12   # H100 SXM dense bf16 FLOP/s (NVIDIA's data sheet)
PEAK_HBM = 3.35e12   # H100 SXM HBM3 bytes/s
SFU_EXP_PER_CLOCK = 16 * 132  # exponentials a clock on the SFUs: 16 an SM, 132 SMs
SM_CLOCK_HZ = 1.98e9  # the H100 SXM's highest SM clock
B2 = 2  # bytes of a bf16 element


def bound_s(flops: float, nbytes: float, exps: float = 0.0) -> tuple[float, str]:
    """(least seconds the H100 could take, what bounds it): the larger of
    the products' flops over the bf16 peak, the bytes over the HBM rate
    and the exponentials over the SFUs at the highest clock."""
    cands = ((flops / PEAK_BF16, "operations"), (nbytes / PEAK_HBM, "bytes"),
             (exps / (SFU_EXP_PER_CLOCK * SM_CLOCK_HZ), "exponentials"))
    return max(cands, key=lambda c: c[0])


def dense_flops_per_row(d: int, mlp: int) -> int:
    """qkv (d -> 3d), projection (d -> d), W1 (d -> mlp), W2 (mlp -> d)."""
    return 2 * d * (3 * d + d + 2 * mlp)


def attention_flops(n_seq: int, length: int, heads: int, dh: int) -> int:
    """QK^T and PV of every head of n_seq sequences of ``length`` rows."""
    return n_seq * heads * length * length * dh * 4


# --------------------------------------------------------------- ViT lifter

def vit_block_elems(d: int, mlp: int) -> int:
    """One trunk block's weights: two LayerNorms before attention and one
    before the MLP, qkv and projection without bias, the MLP with."""
    return 3 * 2 * d + 3 * d * d + d * d + d * mlp + mlp + mlp * d + d


def trunk_call_bound(cfg: dict, frames: int) -> tuple[float, str]:
    """The ViT trunk (every block's qkv, attention and rest launches) on a
    bucket of ``frames``: the tokens and PE read once, the output written
    once, the weights read once (``kernel_bounds``' "lifter_trunk"), and
    one exponential a score."""
    j, d, h = cfg["n_joints"], cfg["hidden"], cfg["heads"]
    dh, mlp, nb = cfg["head_dim"], cfg["mlp_hidden"], cfg["n_blocks"]
    rows = frames * j
    flops = nb * (rows * dense_flops_per_row(d, mlp) + attention_flops(frames, j, h, dh))
    nbytes = 2 * rows * d * B2 + j * d * B2 + nb * vit_block_elems(d, mlp) * B2
    exps = nb * frames * h * j * j
    return bound_s(flops, nbytes, exps)


def vit_frame_flops(cfg: dict) -> int:
    """Products of one frame's forward: embed, every block, the head."""
    j, d, h = cfg["n_joints"], cfg["hidden"], cfg["heads"]
    dh, mlp, hh = cfg["head_dim"], cfg["mlp_hidden"], cfg["head_hidden"]
    embed = j * 2 * cfg["in_dim"] * d
    blocks = cfg["n_blocks"] * (j * dense_flops_per_row(d, mlp) + attention_flops(1, j, h, dh))
    head = j * 2 * (d * hh + hh * cfg["out_dim"])
    return embed + blocks + head


# ----------------------------------------------------------- temporal lifter

def sub_block_elems(d: int, mlp: int) -> int:
    """One sub-block's weights: two LayerNorms, qkv and projection with
    bias, the MLP with bias."""
    return 2 * 2 * d + 3 * d * d + 3 * d + d * d + d + d * mlp + mlp + mlp * d + d


def _temporal_shapes(cfg: dict, clips: int):
    j, d, h, t = cfg["n_joints"], cfg["hidden"], cfg["heads"], cfg["clip_len"]
    dh, mlp = cfg["head_dim"], cfg["mlp_ratio"] * cfg["hidden"]
    rows = clips * t * j
    att_spatial = attention_flops(clips * t, j, h, dh)
    att_temporal = attention_flops(clips * j, t, h, dh)
    exps_spatial = clips * t * h * j * j
    exps_temporal = clips * j * h * t * t
    return rows, d, mlp, att_spatial, att_temporal, exps_spatial, exps_temporal


def sub_block_fwd_bounds(cfg: dict, clips: int) -> dict[str, tuple[float, str]]:
    """The training forwards of one block's two halves (``kernel_bounds``'
    "spatial_fwd", "slab_fwd"): x read, out, x1 and att written, weights
    read; the four products and the attention's."""
    rows, d, mlp, a_s, a_t, e_s, e_t = _temporal_shapes(cfg, clips)
    dense = rows * dense_flops_per_row(d, mlp)
    nbytes = 4 * rows * d * B2 + sub_block_elems(d, mlp) * B2
    return {"spatial": bound_s(dense + a_s, nbytes, e_s),
            "temporal": bound_s(dense + a_t, nbytes, e_t)}


def sub_block_bwd_bounds(cfg: dict, clips: int) -> dict[str, tuple[float, str]]:
    """The backwards of one block's two halves (``kernel_bounds``'
    "spatial_bwd", "slab_bwd"): x, x1, att and dout read, dx written, the
    weights read (bf16) and their gradients written (f32); the recomputed
    qkv and W1 products, twice the forward's four (the transposed products
    and the weight gradients), 2.5 times its attention products (scores
    recomputed, dA, dV, dQ, dK), one exponential a score."""
    rows, d, mlp, a_s, a_t, e_s, e_t = _temporal_shapes(cfg, clips)
    recompute = 2 * d * (3 * d + mlp)
    dense = rows * (recompute + 2 * dense_flops_per_row(d, mlp))
    nbytes = 5 * rows * d * B2 + sub_block_elems(d, mlp) * (B2 + 4)
    return {"spatial": bound_s(dense + 2.5 * a_s, nbytes, e_s),
            "temporal": bound_s(dense + 2.5 * a_t, nbytes, e_t)}


def temporal_forward_flops(cfg: dict, clips: int) -> int:
    """Products of one forward over ``clips`` clips: embed, every block's
    two halves, the head."""
    rows, d, mlp, a_s, a_t, _, _ = _temporal_shapes(cfg, clips)
    embed = rows * 2 * cfg["in_dim"] * d
    blocks = cfg["n_blocks"] * (2 * rows * dense_flops_per_row(d, mlp) + a_s + a_t)
    head = rows * 2 * (d * cfg["head_hidden"] + cfg["head_hidden"] * cfg["out_dim"])
    return embed + blocks + head


def temporal_step_flops(cfg: dict, clips: int) -> int:
    """A training step: the forward and the backward's two products for
    each of its products."""
    return 3 * temporal_forward_flops(cfg, clips)
