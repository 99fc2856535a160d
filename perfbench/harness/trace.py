"""The traced window: torch.profiler over it, and the reduction of its
Chrome trace to what the per-layer metrics read.

- Device activity is every kernel, copy and set the trace holds
  (``kernel``, ``gpu_memcpy``, ``gpu_memset``), clipped to the window: the
  span ``perfbench.window`` that the harness opens after a synchronise
  and closes after another.
- Attribution: each device event is linked by its correlation id to the
  host call that launched it (a ``cuda_runtime`` or ``cuda_driver``
  event), and that call to the host spans that enclose it on its thread
  (``cpu_op``, ``user_annotation``). The innermost enclosing span whose
  name matches a group's ``ops`` pattern names the group; failing that,
  a launch under any PyTorch op goes to ``aten``; failing that, a kernel
  whose name matches a group's ``kernels`` pattern goes to that group;
  the rest to ``other``. The groups' patterns (regular expressions,
  searched) come from ``perfbench/names/<group>/*.json``, all files of a
  group merged.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import re
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "perfbench.window"
TOP = 10
SCAN = 4096  # host spans looked back over for the one that covers a gap


class Tracer:
    """Profiles one window on ``device`` and writes its trace to ``path``.

    With ``host_ops`` the profiler records the host's PyTorch ops and
    spans besides the device's work, for attribution; that costs the host
    a few microseconds an op, so a window that the host paces runs slower
    under it. Without, it records the device's work alone, and the
    window's length is the host's clock from the profiler's start to the
    closing synchronise."""

    def __init__(self, path: Path, device, host_ops: bool):
        self.path, self.device, self.host_ops = Path(path), device, host_ops
        self.window_s = None

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        import time

        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CUDA] if self.device.type == "cuda" else []
        if self.host_ops or not acts:
            acts.append(ProfilerActivity.CPU)
        self._sync()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                t0 = time.perf_counter()
                yield
                self._sync()
                self.window_s = time.perf_counter() - t0
        prof.export_chrome_trace(str(self.path))

    @staticmethod
    def span(name: str):
        from torch.profiler import record_function
        return record_function(name)

    def load(self, groups: dict[str, dict]) -> "TraceView":
        return load(self.path, groups, None if self.host_ops else self.window_s)


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(merged, s: float, e: float) -> float:
    """Length of [s, e] that the merged intervals cover."""
    i = max(bisect.bisect_right(merged, (s, float("inf"))) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < e:
        a, b = max(merged[i][0], s), min(merged[i][1], e)
        if b > a:
            total += b - a
        i += 1
    return total


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and arguments."""
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:limit]


class TraceView:
    """The window's device activity, attributed to groups."""

    def __init__(self, events: list, groups: dict[str, dict], window_s: float | None = None):
        self.groups = {g: {"ops": [re.compile(p) for p in spec.get("ops", [])],
                           "kernels": [re.compile(p) for p in spec.get("kernels", [])]}
                       for g, spec in groups.items()}
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        wins = [e for e in xs if e.get("name") == WINDOW and e.get("cat") in HOST_CATS]
        if window_s is not None:  # no host spans: the device's work, all of it inside
            starts = [float(e["ts"]) for e in xs if e.get("cat") in DEVICE_CATS] or [0.0]
            self.t0, self.t1, self.main = min(starts), min(starts) + window_s * 1e6, None
        elif wins:
            win = max(wins, key=lambda e: e["dur"])
            self.t0, self.t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
            self.main = (win.get("pid"), win.get("tid"))
        else:
            raise ValueError(f"the trace has no {WINDOW} span")
        self.host = defaultdict(list)  # (pid, tid) -> [(ts, end, name, cat)]
        for e in xs:
            if e.get("cat") in HOST_CATS:
                ts = float(e["ts"])
                self.host[(e.get("pid"), e.get("tid"))].append(
                    (ts, ts + float(e["dur"]), e["name"], e["cat"]))
        for evs in self.host.values():
            evs.sort(key=lambda r: (r[0], -r[1]))
        launches = {}
        for e in xs:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = ((e.get("pid"), e.get("tid")),
                                                      float(e["ts"]))
        self.device = []  # (start, end, name, group) inside the window
        pending = []
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            s, t = max(s, self.t0), min(t, self.t1)
            if t <= s:
                continue
            link = launches.get(e.get("args", {}).get("correlation"))
            pending.append((s, t, e["name"], link))
        self._attribute(pending)
        self.busy = union((s, t) for s, t, _, _ in self.device)

    # -------------------------------------------------------- attribution

    def _ancestors(self, queries):
        """{query index: [(name, cat), ... outermost first]} of the host
        spans enclosing each (thread, time) query."""
        by_thread = defaultdict(list)
        for i, (thread, ts) in queries:
            by_thread[thread].append((ts, i))
        out = {}
        for thread, qs in by_thread.items():
            qs.sort()
            evs, k, stack = self.host.get(thread, []), 0, []
            for ts, i in qs:
                while k < len(evs) and evs[k][0] <= ts:
                    while stack and stack[-1][1] <= evs[k][0]:
                        stack.pop()
                    stack.append(evs[k])
                    k += 1
                while stack and stack[-1][1] < ts:
                    stack.pop()
                out[i] = [(r[2], r[3]) for r in stack if r[0] <= ts <= r[1]]
        return out

    def _group(self, name: str, chain) -> str:
        for op, _ in reversed(chain):
            for g, spec in self.groups.items():
                if any(p.search(op) for p in spec["ops"]):
                    return g
        if any(cat == "cpu_op" for _, cat in chain):
            return "aten"
        for g, spec in self.groups.items():
            if any(p.search(name) for p in spec["kernels"]):
                return g
        return "other"

    def _attribute(self, pending):
        queries = [(i, link) for i, (_, _, _, link) in enumerate(pending) if link]
        chains = self._ancestors(queries)
        for i, (s, t, name, _) in enumerate(pending):
            self.device.append((s, t, name, self._group(name, chains.get(i, []))))

    # ------------------------------------------------------------ readings

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def idle_pct(self) -> float | None:
        """The window less the union of every device activity (kernels,
        copies, sets), over the window."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def group_s(self, group: str) -> float:
        """Device seconds of the group's events (overlaps counted once)."""
        return sum(e - s for s, e in union((s, t) for s, t, _, g in self.device
                                           if g == group)) * 1e-6

    def n_device_events(self) -> int:
        return len(self.device)

    def spans(self, name: str) -> list[tuple[float, float]]:
        """(start, end) in microseconds of the main thread's spans named
        ``name`` inside the window."""
        return [(s, e) for s, e, n, _ in self.host.get(self.main, [])
                if n == name and s >= self.t0 and e <= self.t1]

    def busy_within(self, s: float, e: float) -> float:
        """Device-busy microseconds inside [s, e]."""
        return covered(self.busy, s, e)

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host span on the main thread at each
        gap's start."""
        ops = defaultdict(float)
        for s, t, n, _ in self.device:
            ops[short_name(n)] += (t - s) * 1e-6
        gaps = defaultdict(float)
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        host = self.host.get(self.main, [])
        starts = [r[0] for r in host]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            gaps[self._host_at(host, starts, a)] += (b - a) * 1e-6
        top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}

    @staticmethod
    def _host_at(host, starts, ts: float) -> str:
        i = bisect.bisect_right(starts, ts) - 1
        for j in range(i, max(i - SCAN, -1), -1):  # the latest start that covers ts
            s, e, n, _ = host[j]
            if e >= ts and n != WINDOW:
                return f"host: {n}"
        return "host: (no span)"


def load(path: Path, groups: dict[str, dict], window_s: float | None = None) -> TraceView:
    with open(path) as f:
        data = json.load(f)
    return TraceView(data["traceEvents"] if isinstance(data, dict) else data, groups, window_s)
