"""The import rule: a run loads nothing of JAX or of the JAX package, and
the references load nothing of the program. Top-level names, the part
before the first dot, are compared whole: ``pose3d_tpu_torch`` is not
``pose3d_tpu``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from perfbench.tests.conftest import REPO, SMALL, copy_benchmark

FORBIDDEN = {"jax", "jaxlib", "flax", "pose3d_tpu"}
PROGRAM = "pose3d_tpu_torch"

RUN = """
import json, sys, time
sys.path.insert(0, {repo!r})
from perfbench.harness import core
from perfbench.harness.registry import Registry
import perfbench.run
reg = Registry({root!r})
for w in ("vit.serve", "temporal.train"):
    core.run(reg, w, 5, 0.2, False, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFS = """
import json, sys
sys.path.insert(0, {repo!r})
import perfbench.references.vit_lifter, perfbench.references.temporal_lifter
import perfbench.harness.bounds, perfbench.harness.compare, perfbench.harness.weights
import perfbench.harness.synthetic
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    names = loaded(RUN.format(repo=str(REPO), root=str(copy_benchmark(tmp_path, SMALL))))
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert PROGRAM in names


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, str(REPO / "perfbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    sys.modules["pose3d_tpu_torch_probe.x"] = sys.modules[__name__]
    try:
        assert "pose3d_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["pose3d_tpu_torch_probe.x"]


def test_references_load_nothing_of_the_program():
    names = loaded(REFS.format(repo=str(REPO)))
    assert not names & (FORBIDDEN | {PROGRAM}), names & (FORBIDDEN | {PROGRAM})


def test_reference_sources_import_no_program():
    for path in sorted((REPO / "perfbench" / "references").glob("*.py")):
        tree = ast.parse(Path(path).read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN | {PROGRAM}, (path.name, m)
