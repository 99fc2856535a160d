"""Rules of the PyTorch port that no parity test sees.

- ``pose3d_tpu_torch`` runs where JAX is absent: importing it pulls in no
  ``jax``, ``flax`` or ``pose3d_tpu`` (checked in a fresh interpreter,
  since ``tests/conftest.py`` imports JAX into this one).
- Its kernels are built from the repository's own CUDA sources with
  ``nvcc`` for ``sm_90a`` and bound through ctypes, and the launcher
  reports CUDA errors to the caller.
- Importing a module builds nothing.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "pose3d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pose3d_tpu")
# the package's own sources, not what a build or a run left in _build/
SOURCES = sorted(p for p in PKG.rglob("*.py")
                 if "_build" not in p.relative_to(PKG).parts)


def _top(name: str) -> str:
    return name.split(".")[0]


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import pose3d_tpu_torch, pose3d_tpu_torch.serving\n"
        "import pose3d_tpu_torch.interop.weights\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"imported: {proc.stdout.strip()}"


@pytest.mark.parametrize("path", SOURCES + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert _top(name) not in FORBIDDEN, f"{path.name} imports {name}"


def test_kernel_build_is_nvcc_for_sm90a_from_repo_sources():
    from pose3d_tpu_torch.ops import _build

    assert _build.CSRC == PKG / "csrc"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR == PKG / "_build"
    assert _build.library_path().parent == _build.BUILD_DIR
    src = (PKG / "csrc" / "lifter_trunk.cu").read_text()
    assert 'extern "C" cudaError_t lifter_trunk_launch' in src
    assert "return cudaGetLastError();" in src
    for lib_call in ("cublas", "cudnn", "cutlass::gemm::device"):
        assert lib_call not in src.lower()
    gitignore = (REPO / ".gitignore").read_text().splitlines()
    assert "pose3d_tpu_torch/_build/" in gitignore


def test_kernel_constants_match_the_wrapper():
    """The .cu file's tile and layout constants are the Python wrapper's
    (the launcher refuses a mismatch at run time; this catches it here)."""
    from pose3d_tpu_torch.ops import lifter as L

    src = (PKG / "csrc" / "lifter_trunk.cu").read_text()
    assert f"constexpr int kFrames = {L.FRAMES_PER_CTA};" in src
    offsets = [line.split("constexpr int ")[1].split(" =")[0]
               for line in src.splitlines()
               if line.startswith("constexpr int kOff")]
    names = ["kOff" + "".join(p.capitalize() for p in name.split("_"))
             for name, *_ in L._BLOCK_LAYOUT]
    assert offsets == names


def test_import_builds_nothing(tmp_path):
    code = (
        "import pose3d_tpu_torch.ops._build as b, pose3d_tpu_torch.serving\n"
        "print(b.library.cache_info().currsize)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "0"


def test_missing_nvcc_raises(monkeypatch):
    from pose3d_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
