"""Readings that set the limits of a cell's check, on the card at the
cell's own size, many seeds in one process:

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 [--seconds 1]

For each seed it makes the cell's set-up, runs a short window (none for
a training cell, whose readings come from its set-up's first steps),
frees the program and prints one JSON line: the program's gaps from the
plain reference (``program``), each control's (``fp8``, ``int8``: the
reference computed with such products in the program's place; the cell
file names the one its check is held to) and, with ``--faults``, each
fault of ``harness/faults.py`` planted in the program. The benchmark's
own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--raw", help="a file to append each seed's raw readings to (training)")
    ap.add_argument("--controls", default="fp8,int8", help="the lower precisions read")
    ap.add_argument("--faults", action="store_true", help="read each planted fault too")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness.faults import FAULTS
    from perfbench.harness.registry import Registry

    reg = Registry(ROOT)
    cell = reg.workload(args.workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    driver = reg.driver(traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        c = driver.Cell(cfg, traffic, seed, torch.device(args.device))
        if args.seconds > 0:
            c.window(args.seconds)
        c.release()
        controls = args.controls.split(",")
        out = {"seed": seed, "program": c.check(), **{p: c.control(p) for p in controls}}
        if args.raw and traffic["driver"] == "train_step":
            raw = {"seed": seed, "program": c.readings, "reference": c._ref[0][0],
                   **{p: c.reference(p)[0] for p in controls}}
            with open(args.raw, "a") as f:
                f.write(json.dumps(raw) + "\n")
        del c
        for fault in FAULTS[traffic["driver"]] if args.faults else ():
            f = driver.Cell(cfg, traffic, seed, torch.device(args.device), (fault,))
            if args.seconds > 0:
                f.window(args.seconds)
            f.release()
            out[fault.__name__] = f.check()
            del f
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
