"""Faults planted under a cell's timed path, which its check must catch:
each takes the driver's cell object once its program is built and breaks
the path the window drives. The benchmark's runs plant none; its tests
and ``control.py`` do."""

from __future__ import annotations


def leave_half_out(cell):
    """Serving: the second half of each bucket's rows left out (zeros)."""
    fwd = cell.svc._forward

    def half(x):
        y = fwd(x)
        y[len(y) // 2:] = 0
        return y
    cell.svc._forward = half


def alter_an_answer(cell):
    """Serving: one frame's pose altered where the forward produces it."""
    fwd = cell.svc._forward

    def altered(x):
        y = fwd(x)
        y[0, 5, 1] += 0.25
        return y
    cell.svc._forward = altered


def state_unchanged(cell):
    """Training: the step leaves the parameters and AdamW's state as they
    were."""
    cell.state.optimizer.step = lambda *a, **k: None


def half_batch(cell):
    """Training: half of each batch left out, the loss's mean taken over
    the rest."""
    step = cell.step_fn
    cell.step_fn = lambda state, y1, y2: step(state, y1[:len(y1) // 2], y2[:len(y2) // 2])


def gradient_doubled(cell):
    """Training: one leaf's gradient altered (doubled) where it is
    produced."""
    cell.state.model.embed.weight.register_hook(lambda g: 2 * g)


FAULTS = {"lift": (leave_half_out, alter_an_answer),
          "train_step": (state_unchanged, half_batch, gradient_doubled)}
