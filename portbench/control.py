"""The control of a cell: the plain reference put in the program's place,
with one guarantee of the configuration broken (its ``control``: see
``check.py``), judged exactly as a run judges the program, at the cell's
own size. It has to come out not correct; the benchmark's runs never run
it.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--device cuda]

prints one JSON line a seed: the readings (each beside its limit), the
answers compared, and whether the control came out correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(name: str, seed: int, device: str, overrides: dict | None = None) -> dict:
    from . import core, paths, traffic

    workload, config = core.cell(core.benchmark(), name)
    workload = {**workload, **(overrides or {})}
    t0 = time.perf_counter()
    inputs = traffic.draw(workload, seed)
    checks, compared = paths.load(workload["path"]).control(workload, config, inputs, seed, device)
    return {"workload": name, "seed": seed, "control": config["control"],
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
            "answers_compared": compared, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
