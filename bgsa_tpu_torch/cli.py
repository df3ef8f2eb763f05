"""``bgsa-torch-align``: the aligner CLI on a torch device.

Counterpart of ``bgsa-align`` (``bgsa_tpu.cli.align_main``) on CUDA
devices: unit-cost Myers scoring and general integer scoring (``-M/-I/-G``,
BitPAl, with ``--packed/--no-packed`` and ``--carry``), global or
``--semi-global``, and the banded filter (``-k``), on one device or split
over local devices (``--shards``). Result files are byte-identical to
``bgsa-align``'s, so ``bgsa-convert`` reads them as they are. Flags of paths
not ported yet (``--host``, ``-t``, ``-n``, ``-R``, ``-D``, ``--sync-dir``,
``--sync-timeout``, ``--profile``, ``--profile-python``) are parsed as
``bgsa-align`` parses them and refused with exit 1, naming the ROADMAP item
that ports them. ``--backend`` picks between the TPU kernels and their XLA
twins in ``bgsa-align``; the port has one CUDA kernel per route, so it
accepts ``--backend auto`` and does nothing with it, and refuses ``pallas``
and ``xla`` with exit 1.
"""

from __future__ import annotations

import argparse
import atexit
import os
import sys
import tempfile

from .schemes import Mode, Scoring

_NOT_PORTED = {  # argparse dest -> (flag, what it is and the ROADMAP item)
    "host": ("--host", "multi-host roles, ROADMAP queue 1 #8b"),
    "devices": ("-t", "heterogeneous co-compute, ROADMAP queue 1 #8a"),
    "device_count": ("-n", "the device count of heterogeneous co-compute, ROADMAP queue 1 #8a"),
    "ratio_file": ("-R", "device/host ratios of multi-host roles, ROADMAP queue 1 #8b"),
    "dynamic": ("-D", "dynamic balancing, ROADMAP queue 1 #8b"),
    "sync_dir": ("--sync-dir", "the time exchange of dynamic balancing, ROADMAP queue 1 #8b"),
    "sync_timeout": ("--sync-timeout",
                     "the time exchange of dynamic balancing, ROADMAP queue 1 #8b"),
    "profile": ("--profile", "a profiler trace of the run, ROADMAP queue 1 #13"),
    "profile_python": ("--profile-python", "a profiler trace of the run, ROADMAP queue 1 #13"),
}


def _as_line_format(path: str, error) -> str:
    """FASTA/FASTQ inputs convert to the line format in a temp file (as
    ``bgsa-align`` does); line-format files pass through."""
    if not os.path.exists(path):
        error(f"{path}: no such file")
    with open(path, "rb") as f:
        first = f.read(1)
        is_fastq = False
        if first == b"@":
            f.readline()
            f.readline()
            is_fastq = f.readline()[:1] == b"+"
            if not is_fastq:
                error(f"{path}: starts with '@' but is not valid FASTQ "
                      "(third line of the first record must start with '+')")
    if first != b">" and not is_fastq:
        return path
    from .io import fastx

    tmp = tempfile.NamedTemporaryFile(suffix=".txt", delete=False, prefix="bgsa_")
    tmp.close()
    atexit.register(os.unlink, tmp.name)
    if first == b">":
        fastx.convert_fasta(path, tmp.name)
    else:
        fastx.convert_fastq(path, tmp.name)
    return tmp.name


def align_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bgsa-torch-align", description=__doc__)
    p.add_argument("-q", dest="query", required=True, help="query file (fixed-length lines)")
    p.add_argument("-d", dest="database", required=True, help="database file")
    p.add_argument("-f", dest="result", default="data/result.txt", help="result file")
    p.add_argument("-N", dest="threads", type=int, default=0,
                   help="host packing threads (reference -N; 0 = all cores)")
    p.add_argument("-k", dest="threshold", type=int, default=None, help="banded error threshold")
    p.add_argument("-M", dest="match", type=int, default=None, help="match score (default 0)")
    p.add_argument("-I", dest="mismatch", type=int, default=None,
                   help="mismatch score (default -1)")
    p.add_argument("-G", dest="gap", type=int, default=None, help="gap score (default -1)")
    p.add_argument("--semi-global", action="store_true", help="semi-global mode")
    p.add_argument("--backend", default="auto", choices=["auto", "pallas", "xla"],
                   help="accepted as bgsa-align accepts it; only 'auto' runs (the port has "
                        "one CUDA kernel per route)")
    p.add_argument("--shards", type=int, default=1,
                   help="local device shards (0 = all local devices)")
    p.add_argument("--packed", action=argparse.BooleanOptionalAction, default=None,
                   help="packed bit-plane BitPAl representation (same scores; default on)")
    p.add_argument("--carry", action="store_true",
                   help="full-32-bit-word BitPAl with compare-carry adds (on either "
                        "representation; same scores). Without it the layout is "
                        "picked per route: 31-bit packed, 32-bit non-packed")
    p.add_argument("--bucket-size", type=int, default=None, help="database bucket bytes")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="also write run statistics as JSON")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run (skip completed buckets)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain torch path)")
    p.add_argument("--quiet", action="store_true")
    # accepted only to be refused: these paths are not ported yet
    p.add_argument("--host", default=None, help=argparse.SUPPRESS)
    p.add_argument("-t", dest="devices", default=None, help=argparse.SUPPRESS)
    p.add_argument("-n", dest="device_count", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("-R", dest="ratio_file", default=None, help=argparse.SUPPRESS)
    p.add_argument("-D", dest="dynamic", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--sync-dir", default=None, help=argparse.SUPPRESS)
    p.add_argument("--sync-timeout", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--profile", default=None, help=argparse.SUPPRESS)
    p.add_argument("--profile-python", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    for dest, (flag, what) in _NOT_PORTED.items():
        if getattr(args, dest) not in (None, False):
            print(f"error: {flag} is not ported yet ({what}); use bgsa-align", file=sys.stderr)
            return 1
    if args.backend != "auto":
        print(f"error: --backend {args.backend} has no counterpart in the port (one CUDA "
              "kernel per route); use --backend auto, or bgsa-align", file=sys.stderr)
        return 1
    # explicit scoring flags are told from the defaults, as bgsa-align does
    scoring_explicit = any(v is not None for v in (args.match, args.mismatch, args.gap))
    scoring = Scoring(0 if args.match is None else args.match,
                      -1 if args.mismatch is None else args.mismatch,
                      -1 if args.gap is None else args.gap)
    if args.threshold is not None:
        # the rules of bgsa-align for -k, word for word
        if scoring_explicit:
            print("error: -M/-I/-G cannot combine with -k (the banded filter "
                  "is unit-cost edit distance; drop the scoring flags, or "
                  "drop -k for a general-scoring run)", file=sys.stderr)
            return 1
        if args.semi_global:
            print("error: --semi-global cannot combine with -k (the banded "
                  "filter's mode is fixed: errors are minimized over the "
                  "final subject row, matching the reference's banded "
                  "kernels)", file=sys.stderr)
            return 1
        if args.threshold < 0:
            print("error: -k must be >= 0", file=sys.stderr)
            return 1
    # the rules of bgsa-align for --packed and --carry, word for word
    myers_or_banded = args.threshold is not None or scoring.is_unit
    if args.packed is not None and myers_or_banded:
        print("error: --packed/--no-packed applies to BitPAl scoring "
              "schemes; this run selects a Myers/banded kernel (unit-cost "
              "or -k), which has no packed/non-packed representation choice",
              file=sys.stderr)
        return 1
    if args.carry and myers_or_banded:
        print("error: --carry applies to BitPAl scoring schemes; "
              "this run selects a Myers/banded kernel (unit-cost or -k), "
              "whose full-word formulation is already the TPU default",
              file=sys.stderr)
        return 1

    import torch

    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        p.error(f"--device {args.device}: {e}")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is available; pass --device cpu to run the "
              "plain torch path on the CPU", file=sys.stderr)
        return 1

    from .banded_pipeline import run_banded
    from .pipeline import PipelineConfig, run_alignment

    out_dir = os.path.dirname(args.result)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    query = _as_line_format(args.query, p.error)
    database = _as_line_format(args.database, p.error)
    cfg_kwargs = {
        "host_threads": args.threads,
        "local_shards": args.shards,
        "bitpal_packed": True if args.packed is None else args.packed,
        # store_true, as in bgsa-align: absent means the per-route layout,
        # not "force 31-bit words"
        "bitpal_carry": True if args.carry else None,
    }
    if args.bucket_size:
        cfg_kwargs["bucket_size"] = args.bucket_size
    mode = Mode.SEMI_GLOBAL if args.semi_global else Mode.GLOBAL
    config = PipelineConfig(**cfg_kwargs)
    try:
        if args.threshold is not None:
            stats = run_banded(query, database, args.result, args.threshold, config,
                               resume=args.resume, device=device)
        else:
            stats = run_alignment(query, database, args.result, scoring, mode, config,
                                  resume=args.resume, device=device)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            f.write(stats.to_json() + "\n")
    if not args.quiet:
        print(f"score is {scoring.match}, {scoring.mismatch}, {scoring.gap}")
        print(stats.report())
    return 0


if __name__ == "__main__":
    sys.exit(align_main())
