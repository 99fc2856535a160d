"""One run of one cell: set-up, the window, the metrics, the check.

``run`` returns the result line's object and the lines the check prints.
It takes the device it is given and never looks for a card: ``run.py``
does that before it calls it.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import torch

from perfbench.harness import bounds, trace
from perfbench.harness.registry import Registry

OUT = Path("_out")


class Context:
    """What a per-layer reader reads. ``device``, ``device_info``: the
    window traced without host ops (the device's work at the host's own
    pace) and what the driver counted in it; ``trace``, ``info``: the
    window traced with host ops, for attribution, and its counts; the
    configuration, the traffic, the work counts."""

    def __init__(self, device_view, device_info: dict, view, info: dict, cfg: dict,
                 traffic: dict):
        self.device, self.device_info = device_view, device_info
        self.trace, self.info = view, info
        self.cfg, self.traffic, self.bounds = cfg, traffic, bounds


def device_info(device: torch.device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": device.type, "kind": device.type, "count": chips, "memory_peak_bytes": 0}


def run(reg: Registry, workload: str, seed: int, seconds: float, traced: bool, device,
        t_start: float, faults=()) -> tuple[dict, list[str]]:
    device = torch.device(device)
    seed %= 2 ** 63  # numpy's generators take no negative seed
    cell = reg.workload(workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    driver = reg.driver(traffic["driver"]).Cell(cfg, traffic, seed, device, faults)
    setup_s = time.perf_counter() - t_start
    metrics, breakdown = {}, None
    if traced:
        tracers = [trace.Tracer(reg.dir / OUT / f"{kind}.json", device, host_ops=kind == "host")
                   for kind in ("device", "host")]
        res = driver.window(min(seconds, traffic["trace_seconds"]), tracers[0])
        res_host = driver.window(min(seconds, traffic["attribution_seconds"]), tracers[1])
        counters = driver.counters()
        names = reg.names()
        dview, hview = (t.load(names) for t in tracers)
        ctx = Context(dview, res["info"], hview, res_host["info"], cfg, traffic)
        for m in reg.per_layer(workload):
            value = reg.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": dview.breakdown()["device_ops"],
                     "idle_gaps": hview.breakdown()["idle_gaps"]}
        counters["host_traced_group_s"] = {g: hview.group_s(g) for g in [*names, "aten", "other"]}
        res = {"attempted": res["attempted"] + res_host["attempted"],
               "failed": res["failed"] + res_host["failed"]}
    else:
        res = driver.window(seconds, None)
        counters = driver.counters()
        values = dict(res["e2e"], setup_s=setup_s)
        for m in reg.end_to_end(workload):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = device_info(device, cell["chips"])
    if traced:
        dev.update(busy_s=dview.busy_s, window_s=dview.window_s)
    driver.release()
    gaps = driver.check()
    checks = {k: {"value": gaps[k], "limit": lim} for k, lim in cell["limits"].items()}
    correct = res["failed"] == 0 and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"counters {counters}"]
    lines += [f"reading {k} {v!r} (not compared)" for k, v in gaps.items() if k not in checks]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines
