"""The served temporal forwards' spans in the window traced with host
ops: ``pose3d.temporal.trunk`` (a forward's blocks) and
``pose3d.temporal.fuse`` (each DSTformer stream fusion, inside the trunk).

``view(reader_file)`` loads the trace ``core.run`` wrote for that window
(``<perfbench>/_out/host.json``, found from the reader's own path) with
``trace.load``, attributed by these two span names alone: a device event
goes to the innermost of them around its launch. The file is parsed once
for each modification time. A program that records neither span leaves
both groups empty.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

from perfbench.harness import core, trace

TRUNK, FUSE = "pose3d.temporal.trunk", "pose3d.temporal.fuse"
GROUPS = {name: {"ops": [f"^{re.escape(name)}$"], "kernels": []} for name in (TRUNK, FUSE)}


@functools.lru_cache(maxsize=1)
def _load(path: str, mtime_ns: int) -> trace.TraceView:
    return trace.load(Path(path), GROUPS)


def view(reader_file) -> trace.TraceView:
    """The host-ops window's trace beside the reader, grouped by span."""
    path = Path(reader_file).resolve().parents[1] / core.OUT / "host.json"
    return _load(str(path), path.stat().st_mtime_ns)
