"""Runs one cell of the port's benchmark once and prints its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits non-zero and prints no result where
no CUDA card is available, or fewer than the cell asks for, and where
``jax``, ``jaxlib``, ``flax`` or ``pose3d_tpu`` is loaded once the window
has closed. The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks``: each number compared with its limit); the
last lines of standard error are the counters and the same checks.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pose3d_tpu"}
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "nv_compute"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "perfbench" / "_cache" / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import core
    from perfbench.harness.registry import Registry

    reg = Registry(ROOT)
    chips = reg.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    result, lines = core.run(reg, args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
