"""``examples/end_to_end_torch.py --cpu``: the port's walkthrough at toy
sizes (the trainers, the video pipeline, serving, and two spawned
``gloo`` ranks serving and taking a DP temporal step), run as a user runs
it, in a subprocess; it imports neither JAX nor the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "examples" / "end_to_end_torch.py"


def test_example_imports_no_jax():
    names = set()
    for node in ast.walk(ast.parse(EXAMPLE.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert not {n for n in names if n.split(".")[0] in ("jax", "flax", "pose3d_tpu")}
    assert "pose3d_tpu_torch.parallel" in names


def test_end_to_end_on_the_cpu(tmp_path):
    proc = subprocess.run([sys.executable, str(EXAMPLE), "--cpu", "--workdir", str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    for i in range(1, 9):
        assert f"[{i}/8]" in out
    assert "DP serving over 2 ranks (gloo, cpu): (100, 17, 3)" in out
    assert "parameters equal on every rank" in out
    assert out.rstrip().endswith("== DONE ==")
    assert (tmp_path / "videos" / "MB_npy" / "skel.mp4.npy").exists()
