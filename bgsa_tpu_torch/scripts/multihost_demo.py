"""The multi-host merge demo on torch devices: N host roles, merged.

The twin of ``scripts/multihost_demo.py`` (BASELINE config 5: 10M x 150 bp
subjects). It runs N ``--host I:N`` roles of ``python -m
bgsa_tpu_torch.cli align`` over one dataset (one after another, or
concurrently with ``--concurrent``), then ``merge`` and ``convert``, and
compares the converted text byte for byte with a single-host run's, for
Myers and (with ``--banded``) the banded filter at ``--k``. The layout is
the reference's multi-device one (original/BGSA_KNC/cal_all.c:136-769:
subjects scattered by ratio, each device's sub-blocks concatenated in
``.info`` order).

    python -m bgsa_tpu_torch.scripts.multihost_demo DIR                   # full 10M
    python -m bgsa_tpu_torch.scripts.multihost_demo DIR --subjects 200000 --hosts 2 --banded
    python -m bgsa_tpu_torch.scripts.multihost_demo DIR --subjects 2000 --device cpu

The dataset is ``scripts/make_testdata.py``'s (seed 1: ``--queries`` x
``--length`` bp queries, then ``--subjects`` subjects), made in this
process by ``benchutil.make_testdata`` (kept when DIR holds it). ``--device
(default ``cuda``; ``cpu`` runs the plain versions) goes to every ``align``;
without a GPU and without ``--device cpu`` the demo exits 1. Concurrent
roles on the CPU run with ``OMP_NUM_THREADS=2``: N roles with torch's
default threads on one host spin on each other's cores (two took 140 s
against 4 s on an 8-core host). Each step's seconds go to stderr, the report
to ``DIR/report.json`` and stdout. Byte equality of the merged output with
the single-host run is the correctness claim; a difference exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
CLI = "bgsa_tpu_torch.cli"


def fail(message: str):
    print(f"[demo] {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def sh(args, env_extra=None, tag=""):
    """Run one command from the repository's root; its seconds. A failed
    command ends the demo (exit 1)."""
    env = {**os.environ, **(env_extra or {})}
    t0 = time.perf_counter()
    print(f"[demo] run{' ' + tag if tag else ''}: {' '.join(args)}", file=sys.stderr, flush=True)
    proc = subprocess.run(args, env=env, cwd=REPO)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"FAILED ({tag}): {' '.join(args)}")
    print(f"[demo] done {tag} in {dt:.1f}s", file=sys.stderr, flush=True)
    return dt


def cli(*args, env_extra=None, tag=""):
    return sh([sys.executable, "-m", CLI, *args], env_extra=env_extra, tag=tag)


def same_bytes(a, b) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def run_family(name, qp, sp, outdir, hosts, extra, args):
    """The single-host run, the roles, merge and convert of one family ->
    its stats (seconds of each step, and the byte check)."""
    fam_dir = os.path.join(outdir, name)
    os.makedirs(fam_dir, exist_ok=True)
    device = ["--device", args.device]
    stats = {}

    single_conv = os.path.join(fam_dir, "single.txt")
    if not args.skip_single:
        single = os.path.join(fam_dir, "single.bin")
        stats["single_s"] = cli("align", "-q", qp, "-d", sp, "-f", single, *extra, *device,
                                tag=f"{name} single-host")
        cli("convert", "-r", single, "-o", single_conv, tag=f"{name} convert single")

    shards = [os.path.join(fam_dir, f"shard{h}.bin") for h in range(hosts)]
    role_cmds = [["align", "-q", qp, "-d", sp, "-f", shards[h], "--host", f"{h}:{hosts}",
                  *extra, *device] for h in range(hosts)]
    if args.concurrent:
        env = {**os.environ, **({"OMP_NUM_THREADS": "2"} if args.device == "cpu" else {})}
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-m", CLI, *cmd], cwd=REPO, env=env)
                 for cmd in role_cmds]
        try:
            for h, p in enumerate(procs):
                if p.wait() != 0:
                    fail(f"role {h} failed")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        stats["roles_s"] = [time.perf_counter() - t0] * hosts
    else:
        stats["roles_s"] = [cli(*cmd, tag=f"{name} role {h}/{hosts}")
                            for h, cmd in enumerate(role_cmds)]

    merged = os.path.join(fam_dir, "merged.bin")
    stats["merge_s"] = cli("merge", *shards, "-o", merged, tag=f"{name} merge")
    merged_conv = os.path.join(fam_dir, "merged.txt")
    stats["convert_s"] = cli("convert", "-r", merged, "-o", merged_conv,
                             tag=f"{name} convert merged")

    if not args.skip_single:
        t0 = time.perf_counter()
        same = same_bytes(merged_conv, single_conv)
        stats["compare_s"] = time.perf_counter() - t0
        if not same:
            fail(f"{name}: merged output != single-host output")
        stats["byte_equal_vs_single_host"] = True
        print(f"[demo] {name}: merged {hosts}-role output BYTE-EQUAL to the single-host run",
              file=sys.stderr, flush=True)
    return stats


def parser():
    ap = argparse.ArgumentParser(prog="python -m bgsa_tpu_torch.scripts.multihost_demo",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("outdir")
    ap.add_argument("--subjects", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--length", type=int, default=150)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--k", type=int, default=8, help="banded threshold")
    ap.add_argument("--banded", action="store_true", help="also run the banded family")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every align (default cuda; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--concurrent", action="store_true",
                    help="run the roles concurrently (on one card they share it)")
    ap.add_argument("--skip-single", action="store_true",
                    help="skip the single-host reference run (no byte check)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from ..benchutil import make_testdata, script_device

    if script_device(args.device) is None:
        return 1
    args.outdir = os.path.abspath(args.outdir)  # the commands run from the repository's root
    os.makedirs(args.outdir, exist_ok=True)
    t0 = time.perf_counter()
    qp, sp = make_testdata(args.outdir, args.queries, args.subjects, args.length)
    print(f"[demo] dataset in {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)

    report = {"subjects": args.subjects, "queries": args.queries, "length": args.length,
              "hosts": args.hosts, "device": args.device, "families": {}}
    report["families"]["myers"] = run_family("myers", qp, sp, args.outdir, args.hosts, [], args)
    if args.banded:
        report["families"]["banded"] = run_family(
            "banded", qp, sp, args.outdir, args.hosts, ["-k", str(args.k)], args)

    out = os.path.join(args.outdir, "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    print(f"[demo] report: {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
