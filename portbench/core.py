"""One run of one cell: set up, warm, measure for ``seconds``, check, report.

Everything that belongs to one configuration, workload or metric is a file
found by its name: ``configs/<config>.json``, ``workloads/<cell>.json``
(its ``path`` names a module of ``paths/``), ``metrics/<metric>.py``
(``read(rec)``, None where it finds nothing to read), and the kernel lists
``kernels/*.json``. ``BENCHMARK.json`` says which metrics a cell reports:
the end-to-end ones with ``--trace 0``, the per-layer ones with
``--trace 1``.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bgsa_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(bench: dict, name: str) -> tuple[dict, dict]:
    """(workload file, configuration file) of cell ``name``, checked against
    BENCHMARK.json's entry where it has one (a workload file without one
    runs, and reports the metrics that every cell reports)."""
    workload = load_json(HERE, "workloads", f"{name}.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry and (workload["config"], workload["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json's entry")
    config = load_json(HERE, "configs", f"{workload['config']}.json")
    return workload, config


def metrics_for(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics cell ``name`` reports: end to end without a trace, per
    layer with one. A metric without ``workloads`` goes to every cell (a
    per-layer one: every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m["workloads"] or ("workloads" not in m and m["moves"] in reported)]


def reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def port_kernels() -> dict:
    """family -> the port's kernel functions, over every list in kernels/."""
    families = {}
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", "*.json"))):
        for family, names in load_json(path).items():
            families.setdefault(family, []).extend(names)
    return families


def card() -> dict:
    """The card's SMs, maximum SM clock and power limit."""
    import torch

    out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm,power.limit",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.split(",")
    return {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "clock_mhz": float(out[0]), "power_limit_w": float(out[1])}


def cells(workload: dict) -> int:
    """Cells a job or call bills, as the reference bills them: query_len x
    query_count x subject_len x subject_count (the banded filter too)."""
    return (workload["queries"] * workload["query_len"] * workload["subjects"]
            * workload["subject_len"])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        overrides: dict | None = None, t0: float | None = None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``overrides`` replaces workload keys (the tests' small sizes)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = benchmark()
    workload, config = cell(bench, name)
    workload = {**workload, **(overrides or {})}
    wanted = metrics_for(bench, name, trace)

    import torch

    import bgsa_tpu_torch

    from . import paths, traffic
    from . import trace as tracing

    pkg = os.path.dirname(os.path.abspath(bgsa_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        raise RuntimeError(f"bgsa_tpu_torch comes from {pkg}, not from this checkout")
    cuda = device != "cpu"
    workdir = tempfile.mkdtemp(prefix="portbench-", dir=tempfile.gettempdir())
    try:
        phases = {"imports": time.perf_counter() - t0}
        inputs = traffic.draw(workload, seed)
        phases["inputs"] = time.perf_counter() - t0 - sum(phases.values())
        path = paths.load(workload["path"]).Path(workload, config, inputs, workdir, device)
        phases["path"] = time.perf_counter() - t0 - sum(phases.values())
        path.warm()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        phases["warm"] = setup_s - sum(phases.values())
        print("setup " + " ".join(f"{k} {v:.3f} s" for k, v in phases.items()), file=sys.stderr)

        jobs, failed = [], 0
        prof = tracing.start(device) if trace else None
        w0 = time.perf_counter()
        now = w0
        while now - w0 < seconds:
            start = now
            record = {}
            try:
                with torch.profiler.record_function(tracing.JOB_SPAN):
                    record = path.job(len(jobs))
                ok = True
            except Exception:  # a failed job counts, and the run goes on
                failed += 1
                ok = False
                if failed == 1:
                    traceback.print_exc()
            now = time.perf_counter()
            jobs.append({**record, "ok": ok, "latency_s": now - start})
        window_s = now - w0
        traced = tracing.stop(prof, os.path.join(workdir, "trace.json")) if trace else None

        if cuda:
            memory_peak = torch.cuda.max_memory_allocated()
            kind = torch.cuda.get_device_name(0)
        else:
            memory_peak, kind = 0, "cpu"
        checks, compared = path.check(seed, device)

        rec = types.SimpleNamespace(
            workload=workload, config=config, jobs=jobs, window_s=window_s, setup_s=setup_s,
            cells_per_job=cells(workload), trace=traced, kernels=port_kernels(),
            card=card() if trace and cuda else None, launches_per_job=path.launches)
        metrics = {}
        for m in wanted:
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {
            "correct": failed == 0 and all(v <= lim for v, lim in checks.values()),
            "attempted": len(jobs),
            "failed": failed,
            "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                       "memory_peak_bytes": memory_peak},
            "answers_compared": compared,
        }
        if trace:
            result["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
            result["breakdown"] = {"device_ops": traced.device_ops(),
                                   "idle_gaps": traced.idle_gaps()}
            if rec.card:
                result["card"] = rec.card
        result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
