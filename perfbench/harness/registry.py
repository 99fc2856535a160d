"""Finds everything by name, from files of its own.

- ``BENCHMARK.json`` at the checkout's root: the cells, configurations
  and metrics, as the contract states them.
- ``perfbench/cells/<workload>.json``: a cell's configuration, traffic,
  chips, why (each as ``BENCHMARK.json`` has it), how its client loops,
  and the limits of the numbers its check compares.
- The configuration's ``file`` (under ``perfbench/configs/``): its sizes.
- ``perfbench/traffic/<traffic>.json``: a traffic mix's parameters and
  the driver (``perfbench/drivers/<driver>.py``) that runs it.
- ``perfbench/metrics/<metric>.py``: a per-layer metric's reader.
- ``perfbench/names/<group>/*.json``: the op and kernel names a group of
  device time is attributed by, every file of a group merged.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL_KEYS = ("config", "traffic", "chips", "why")


class Registry:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "perfbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        """The cell's file, checked against its ``BENCHMARK.json`` entry."""
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        cell = json.loads((self.dir / "cells" / f"{name}.json").read_text())
        for key in CELL_KEYS:
            if cell.get(key) != entry.get(key):
                raise ValueError(f"{name}: {key} is {cell.get(key)!r} in its cell file and "
                                 f"{entry.get(key)!r} in BENCHMARK.json")
        return cell

    def config(self, name: str) -> dict:
        entry = next(c for c in self.bench["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    @staticmethod
    def driver(name: str):
        return importlib.import_module(f"perfbench.drivers.{name}")

    def _reported(self, kind: str, workload: str) -> list[dict]:
        """The metrics of ``kind`` this cell reports: those that list it,
        and those that list no cell and move (or are) a metric it
        reports."""
        e2e = [m["name"] for m in self.bench["end_to_end"]
               if workload in m.get("workloads", [workload])]
        return [m for m in self.bench[kind]
                if workload in m.get("workloads", [workload])
                and (kind == "end_to_end" or "workloads" in m or m["moves"] in e2e)]

    def end_to_end(self, workload: str) -> list[dict]:
        return self._reported("end_to_end", workload)

    def per_layer(self, workload: str) -> list[dict]:
        return self._reported("per_layer", workload)

    def reader(self, metric: str):
        """The metric's reader module (its name may hold dots)."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def names(self) -> dict[str, dict]:
        groups = {}
        for group_dir in sorted(p for p in (self.dir / "names").iterdir() if p.is_dir()):
            merged = {"ops": [], "kernels": []}
            for f in sorted(group_dir.glob("*.json")):
                spec = json.loads(f.read_text())
                for key in merged:
                    merged[key] += spec.get(key, [])
            groups[group_dir.name] = merged
        return groups
