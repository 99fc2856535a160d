"""Faults planted under the video cells' timed path, which their check
must catch: each takes a ``drivers/video.Cell`` once its model is built
and breaks every clip batch's answer on either route ``lift_sequence`` takes,
the module's forward (a forward hook) and the fused forward of
``ops.stblock`` (replaced until the cell is released). The benchmark's
runs plant none; its tests do."""

from __future__ import annotations

from pose3d_tpu_torch.ops import stblock


def _on_clip_batches(cell, alter):
    """``alter`` each clip batch's (C, L, 17, 3) answer in place."""
    def altered(y):
        alter(y)
        return y

    hook = cell.model.register_forward_hook(lambda module, args, y: altered(y))
    fused = stblock.temporal_forward_fused
    stblock.temporal_forward_fused = lambda module, clips, **kw: altered(fused(module, clips,
                                                                               **kw))
    cell.undo += [hook.remove, lambda: setattr(stblock, "temporal_forward_fused", fused)]


def leave_half_out(cell):
    """The second half of each clip batch's rows left out (zeros)."""
    def half(y):
        y[len(y) // 2:] = 0
    _on_clip_batches(cell, half)


def alter_an_answer(cell):
    """One frame's pose altered where the forward produces it."""
    def one(y):
        y[0, 5, 1] += 0.25
    _on_clip_batches(cell, one)


FAULTS = (leave_half_out, alter_an_answer)
