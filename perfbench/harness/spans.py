"""The program's own spans (``pose3d_tpu_torch.train.debug.span``) in the
window traced with host ops.

``view(reader_file)`` loads the trace ``core.run`` wrote for that window
(``<perfbench>/_out/host.json``, found from the reader's own path, so that
a copied tree reads its own) with ``trace.load``, attributed by the
program's span names alone: a device event goes to the innermost program
span around its launch, else to ``aten`` or ``other`` as ``trace`` says.
The file is parsed once for each modification time, whatever number of
readers ask. A program that records no span leaves every group empty.

``idle_ms`` reads the spans of the view the context already holds.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

from perfbench.harness import core, trace

SPANS = ("pose3d.serve.lift", "pose3d.serve.stage", "pose3d.serve.forward",
         "pose3d.serve.fetch", "pose3d.trunk", "pose3d.lift_sequence.clips",
         "pose3d.lift_sequence.forward", "pose3d.lift_sequence.average", "pose3d.train.step",
         "pose3d.train.forward", "pose3d.train.backward", "pose3d.train.optimizer",
         "pose3d.train.pack")
GROUPS = {name: {"ops": [f"^{re.escape(name)}$"], "kernels": []} for name in SPANS}


@functools.lru_cache(maxsize=1)
def _load(path: str, mtime_ns: int) -> trace.TraceView:
    return trace.load(Path(path), GROUPS)


def view(reader_file) -> trace.TraceView:
    """The host-ops window's trace beside the reader, grouped by span."""
    path = Path(reader_file).resolve().parents[1] / core.OUT / "host.json"
    return _load(str(path), path.stat().st_mtime_ns)


def idle_ms(ctx, name: str) -> float | None:
    """Device-idle ms a request inside the spans ``name`` of the host-ops
    window: each span's length less the device's busy time within it,
    summed, over the window's requests. None without such a span."""
    spans, n = ctx.trace.spans(name), ctx.info.get("requests", 0)
    if not spans or not n:
        return None
    return sum(e - s - ctx.trace.busy_within(s, e) for s, e in spans) * 1e-3 / n
