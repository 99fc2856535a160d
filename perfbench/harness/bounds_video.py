"""The video cells' work counts, on ``bounds.py``'s peaks and formulas:
the least time of each served sub-block and of a stream fusion, and the
model flops of a clip frame, from the configuration's widths alone. The
temporal lifter (``family`` "spatio_temporal") runs one stream a block,
the DSTformer ("dstformer") two, each a spatial and a temporal
sub-block, and fuses its two streams after each layer.

A served sub-block reads its input rows once, writes its output rows
once and reads its weights once (bf16); its products are the dense four
of ``bounds.dense_flops_per_row`` and the attention's two, and it takes
one exponential a score. A fusion reads the two streams' rows, writes one
and reads its (2C, 2) weights; its product is 2 · 2C · 2 flops a token.
"""

from __future__ import annotations

from perfbench.harness.bounds import B2, attention_flops, bound_s, dense_flops_per_row, \
    sub_block_elems


def streams(cfg: dict) -> int:
    return 2 if cfg["family"] == "dstformer" else 1


def _widths(cfg: dict):
    d, h = cfg["hidden"], cfg["heads"]
    return cfg["n_joints"], cfg["clip_len"], d, h, d // h, cfg["mlp_ratio"] * d


def sub_block_bounds(cfg: dict, clips: int) -> dict[str, tuple[float, str]]:
    """One spatial and one temporal served sub-block on ``clips`` clips of
    ``clip_len`` frames."""
    j, t, d, h, dh, mlp = _widths(cfg)
    rows = clips * t * j
    dense = rows * dense_flops_per_row(d, mlp)
    nbytes = 2 * rows * d * B2 + sub_block_elems(d, mlp) * B2
    return {"spatial": bound_s(dense + attention_flops(clips * t, j, h, dh), nbytes,
                               clips * t * h * j * j),
            "temporal": bound_s(dense + attention_flops(clips * j, t, h, dh), nbytes,
                                clips * j * h * t * t)}


def trunk_bound_s(cfg: dict, clips: int) -> float:
    """Every served sub-block of one forward over ``clips`` clips."""
    per_block = sum(b for b, _ in sub_block_bounds(cfg, clips).values())
    return cfg["n_blocks"] * streams(cfg) * per_block


def fusion_bound(cfg: dict, clips: int) -> tuple[float, str]:
    """One stream fusion over ``clips`` clips."""
    j, t, d, _, _, _ = _widths(cfg)
    rows = clips * t * j
    return bound_s(rows * 2 * (2 * d) * 2, 3 * rows * d * B2 + (2 * d * 2 + 2) * B2)


def clip_frame_flops(cfg: dict) -> float:
    """Products of one clip frame's forward (its 17 tokens): the embed,
    every block's sub-blocks (a temporal attention's products shared out
    over the clip's frames), the fusions, the head."""
    j, t, d, h, dh, mlp = _widths(cfg)
    sub_blocks = 2 * j * dense_flops_per_row(d, mlp) + attention_flops(1, j, h, dh) \
        + attention_flops(j, t, h, dh) / t
    if cfg["family"] == "dstformer":
        fusion = j * 2 * (2 * d) * 2
        head = j * 2 * (d * cfg["rep_dim"] + cfg["rep_dim"] * cfg["out_dim"])
    else:
        fusion = 0
        head = j * 2 * (d * cfg["head_hidden"] + cfg["head_hidden"] * cfg["out_dim"])
    embed = j * 2 * cfg["in_dim"] * d
    return embed + cfg["n_blocks"] * (streams(cfg) * sub_blocks + fusion) + head
