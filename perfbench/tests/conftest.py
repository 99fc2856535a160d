"""Fixtures of the benchmark's own tests: a copy of the benchmark's files
cut to a size the CPU runs in seconds (the code is the repository's;
only data files are copied), and the card's check for the tests marked
``cuda``."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# the CPU copy's sizes: every width as published, fewer frames and blocks
SMALL = {
    "perfbench/configs/vit_lifter.json": {"max_batch": 64, "min_bucket": 8},
    "perfbench/traffic/serve.json": {"min_frames": 4, "max_frames": 100, "sizes_per_cycle": 16,
                                     "pool_frames": 256, "check_requests": 4, "check_window": 8,
                                     "trace_seconds": 0.3},
    "perfbench/configs/temporal_lifter.json": {"n_blocks": 3, "clip_len": 12},
    "perfbench/traffic/train.json": {"batch_clips": 4, "pool_clips": 16, "warmup_steps": 1,
                                     "trace_seconds": 0.3},
}


def copy_benchmark(dest: Path, sizes=None) -> Path:
    """BENCHMARK.json and perfbench/'s data files under ``dest``, with
    ``sizes`` (file -> keys) written over them."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("_out", "_cache", "__pycache__", "tests"))
    for rel, keys in (sizes or {}).items():
        path = dest / rel
        data = json.loads(path.read_text())
        data.update(keys)
        path.write_text(json.dumps(data))
    return dest


@pytest.fixture
def small_root(tmp_path) -> Path:
    return copy_benchmark(tmp_path, SMALL)


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
