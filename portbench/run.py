"""The port's benchmark: one run of one cell of BENCHMARK.json on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It draws the cell's inputs from the seed,
warms the cell's path, drives ``bgsa_tpu_torch`` for ``--seconds`` seconds
(under ``torch.profiler`` with ``--trace 1``), checks what the timed path
produced against the plain reference, and prints one JSON line last on
stdout: ``correct``, ``attempted``, ``failed``, the cell's metrics
(end-to-end ones with ``--trace 0``, per-layer ones with ``--trace 1``),
``device`` and, traced, ``breakdown``; the numbers compared, each beside
its limit, come last there under ``checks`` and again as the last lines
on stderr. It exits 1 and prints no result where no CUDA device is
visible, and 3 where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for var, sub in CACHES.items():  # fixed directories inside the checkout
        os.environ[var] = os.path.join(root, "build", "portbench", sub)

    import torch

    from portbench import core

    chips = next((w["chips"] for w in core.benchmark()["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 1
    result = core.run(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    loaded = core.forbidden_modules()
    if loaded:
        print(f"error: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
