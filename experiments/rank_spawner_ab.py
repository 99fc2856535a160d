"""Does the port's rank spawner cost time on the card?
``python3 experiments/rank_spawner_ab.py`` on one NVIDIA GPU.

Runs ``chip_smoke.py`` phase 29's two-rank body (``tp_rank``: ``gloo``
ranks sharing cuda:0, the 1 x 2 Martinez steps, the gather, the 2 x 1
SMPL-IK step) four times, alternating how the ranks are spawned:
``parallel.dryrun.run_ranks`` (which polls the ranks and ends them all
when one fails) and a bare ``Process`` + ``join`` per rank, in the order
A B B A. Prints the card's name and power limit, then each run's f32
1 x 2 step time a rank by CUDA events and the gather's.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as C  # noqa: E402
from pose3d_tpu_torch.parallel import mesh as PM  # noqa: E402
from pose3d_tpu_torch.parallel.dryrun import run_ranks  # noqa: E402


def bare_rank(rank: int, world: int, out_dir: str, body_dir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    PM.init_distributed("gloo", device_type="cuda", init_method=f"file://{out_dir}/rdzv")
    try:
        torch.save(C.tp_rank(world, body_dir), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def bare(world: int, body_dir: str) -> list:
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out:
        procs = [ctx.Process(target=bare_rank, args=(r, world, out, body_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(C.TP_DEADLINE_S)
        return [torch.load(f"{out}/rank{r}.pt", weights_only=False) for r in range(world)]


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for name in ("run_ranks", "bare", "bare", "run_ranks"):
        with tempfile.TemporaryDirectory() as body:
            t = time.perf_counter()
            res = (run_ranks(C.tp_rank, 2, "cuda", 2, body, deadline=C.TP_DEADLINE_S)
                   if name == "run_ranks" else bare(2, body))
            print(f"{name}: 1 x 2 f32 step ms by rank {[r['ms'][0] for r in res]}, gather ms "
                  f"{[r['gather_ms'] for r in res]}, {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
