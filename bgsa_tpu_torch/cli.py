"""Command-line interface of the port: ``bgsa-torch-align``, ``-convert``, ``-merge``.

Counterparts of ``bgsa-align``, ``bgsa-convert`` and ``bgsa-merge``
(``bgsa_tpu.cli``) on torch devices. ``bgsa-torch-align`` takes every flag
of ``bgsa-align``, with its checks and messages: unit-cost Myers scoring
and general integer scoring (``-M/-I/-G``, BitPAl, with
``--packed/--no-packed`` and ``--carry``), global or ``--semi-global``, the
banded filter (``-k``); one device or local devices (``--shards``);
heterogeneous co-compute (``-t cuda+cpu``, the reference's ``-t`` spellings,
``-n``, with ``-R`` ratios or ``-D`` balancing); multi-host roles
(``--host I:N|auto``, ``-R``, ``-D``, ``--sync-dir``, ``--sync-timeout``,
``--resume``), each writing a shard and its ``<result>.meta.json`` for
``bgsa-torch-merge``; and ``--profile DIR`` (``--profile-python``), a
``torch.profiler`` trace of the whole run. Result, shard and sidecar files
are byte-identical to ``bgsa_tpu``'s, so either package's ``convert`` and
``merge`` read the other's. ``--device`` (default ``cuda``) picks the
torch device; ``-t`` names its devices itself. ``--backend`` picks between
the TPU kernels and their XLA twins in ``bgsa-align``; the port has one
CUDA kernel per route, so it accepts ``--backend auto`` and does nothing
with it, and refuses ``pallas`` and ``xla`` with exit 1.

``python -m bgsa_tpu_torch.cli [align|convert|merge] ...`` dispatches as
``python -m bgsa_tpu.cli`` does.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import os
import sys
import tempfile

import numpy as np

from .schemes import Mode, Scoring
from .stats import Span


def _auto_host_role() -> tuple[int, int] | None:
    """(host_id, n_hosts) for ``--host auto``: explicit env first, then an
    initialized ``torch.distributed`` group of more than one process (its
    rank and world size)."""
    hid, nh = os.environ.get("BGSA_HOST_ID"), os.environ.get("BGSA_NUM_HOSTS")
    if hid is not None and nh is not None:
        return int(hid), int(nh)
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            return dist.get_rank(), dist.get_world_size()
    except Exception:
        pass
    return None


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


def _profiler(directory: str, with_stack: bool):
    """A ``torch.profiler`` context over CPU activity and, where a CUDA
    device is visible, CUDA activity; on exit it writes a Chrome trace
    (``<host>_<pid>.<time>.pt.trace.json``, TensorBoard's layout) into
    ``directory``."""
    import torch

    os.makedirs(directory, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities, with_stack=with_stack,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(directory),
    )


def _align_checks(argv):
    """``bgsa-torch-align``'s parser, checks and line-format probes: the
    exit code of a refusal, else (args, scoring, mode, config, shard,
    ratios, device, query, database) of the run."""
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
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run (skip completed buckets)")
    p.add_argument("--host", default=None, metavar="I:N",
                   help="multi-host role: this process scores host I's slice of "
                        "every bucket (N hosts total), writing <result> as a raw "
                        "shard plus <result>.meta.json; combine with bgsa-torch-merge. "
                        "'auto' derives I:N from BGSA_HOST_ID/BGSA_NUM_HOSTS or "
                        "an initialized torch.distributed group")
    p.add_argument("-R", dest="ratio_file", default=None,
                   help="device/host ratio file (reference -R: one positive "
                        "float per host, whitespace-separated)")
    p.add_argument("-t", dest="devices", default=None, metavar="SPEC",
                   help="heterogeneous co-compute: '+'-joined torch device types "
                        "(e.g. cuda+cpu), one in-process device section per "
                        "entry (the reference's -t MICSSE; its spellings SIMPLE, "
                        "SSE, MIC and MICSSE are accepted); combine with -R/-D. "
                        "'cpu' entries may repeat, each an engine of its own")
    p.add_argument("-n", dest="device_count", type=int, default=None,
                   help="with a single-platform -t: use this many devices of "
                        "that platform (the reference's -n mic count)")
    p.add_argument("-D", dest="dynamic", action="store_true",
                   help="dynamic load balancing (reference -D): re-split every "
                        "bucket from the measured device/host times; requires "
                        "--host or -t")
    p.add_argument("--sync-dir", default=None, metavar="DIR",
                   help="shared directory for -D time exchange (default: the "
                        "result file's directory). Time files are namespaced "
                        "by a run token derived from the input files; only a "
                        "byte-identical re-run of untouched inputs needs a "
                        "fresh directory")
    p.add_argument("--sync-timeout", type=float, default=None, metavar="SECS",
                   help="-D: seconds to wait for a peer host's per-bucket "
                        "time file before failing with a dead-peer error "
                        "(default 120; the reference hangs forever)")
    p.add_argument("--bucket-size", type=int, default=None, help="database bucket bytes")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="also write run statistics as JSON")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the whole run into DIR "
                        "(CPU activity, and CUDA activity where a card is visible; "
                        "opens in TensorBoard or chrome://tracing)")
    p.add_argument("--profile-python", action="store_true",
                   help="with --profile: also record the Python stack of each "
                        "operator (with_stack; a larger and slower trace)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain torch path). "
                        "-t names its devices itself")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

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

    # the rules of bgsa-align for roles, -t and their flags, word for word
    shard = None
    ratios = None
    if args.host == "auto":
        # Role from the environment: the launcher analogue of the reference's
        # one-process-drives-N-devices split (cal_all.c:71-96).
        role = _auto_host_role()
        if role is None:
            print("error: --host auto: set BGSA_HOST_ID and BGSA_NUM_HOSTS, or "
                  "initialize torch.distributed (init_process_group with a world "
                  "size above 1)", file=sys.stderr)
            return 1
        args.host = "%d:%d" % role
    if args.host is not None:
        try:
            host_id, n_hosts = (int(x) for x in args.host.split(":"))
        except ValueError:
            print(f"error: --host expects I:N, got {args.host!r}", file=sys.stderr)
            return 1
        if not 0 <= host_id < n_hosts:
            print(f"error: --host {args.host}: need 0 <= I < N", file=sys.stderr)
            return 1
        shard = (host_id, n_hosts)
    if args.devices:
        # The reference's own -t spellings (original/BGSA_KNC/main.c:73-83):
        # MIC = the accelerator alone, MICSSE = accelerator + host CPU
        # co-compute, SIMPLE/SSE = CPU-only; mapped to torch device types.
        ref_alias = {"simple": "cpu", "sse": "cpu", "mic": "cuda", "micsse": "cuda+cpu"}
        key = args.devices.strip().lower()
        if key in ref_alias:
            mapped = ref_alias[key]
            if not args.quiet:
                print(f"note: -t {args.devices} (reference spelling) -> -t {mapped}")
            args.devices = mapped
    if args.devices and shard is not None:
        print("error: -t and --host are mutually exclusive (in-process devices "
              "vs multi-host roles)", file=sys.stderr)
        return 1
    if args.devices and args.shards != 1:
        print("error: --shards and -t are mutually exclusive (-t builds one "
              "pinned engine per listed device; to use N devices of one "
              "platform, repeat it or pass -n N)", file=sys.stderr)
        return 1
    if args.devices and (args.resume or args.sync_dir):
        # run_hetero has no resume support (like the reference's in-process
        # heterogeneous mode); silently restarting from scratch would
        # overwrite the user's partial result file.
        flag = "--resume" if args.resume else "--sync-dir"
        print(f"error: {flag} is not supported with -t (in-process "
              "heterogeneous runs restart from scratch; use --host roles "
              "for recoverable runs)", file=sys.stderr)
        return 1
    if args.device_count is not None:
        if not args.devices or "+" in args.devices:
            print("error: -n needs a single-platform -t (e.g. -t tpu -n 4)",
                  file=sys.stderr)
            return 1
        if args.device_count < 1:
            print("error: -n must be >= 1", file=sys.stderr)
            return 1
        args.devices = "+".join([args.devices] * args.device_count)
    if args.dynamic and shard is None and not args.devices:
        print("error: -D requires --host I:N or -t SPEC (dynamic balancing "
              "re-splits device/host slices; single-role runs have nothing "
              "to balance)", file=sys.stderr)
        return 1
    dynamic_hosts = args.dynamic and shard is not None
    if args.sync_timeout is not None and not dynamic_hosts:
        print("error: --sync-timeout applies to -D --host runs (it bounds "
              "the wait for a peer's per-bucket time file); nothing reads "
              "it here", file=sys.stderr)
        return 1
    if args.sync_dir and not dynamic_hosts:
        print("error: --sync-dir applies to -D --host runs (the time-file "
              "exchange directory); nothing reads it here", file=sys.stderr)
        return 1
    if args.profile_python and not args.profile:
        print("error: --profile-python needs --profile DIR", file=sys.stderr)
        return 1
    if args.ratio_file:
        if shard is None and not args.devices:
            # Local sharding splits evenly (homogeneous devices); ratios only
            # steer the multi-host or multi-device split.
            print("error: -R requires --host I:N or -t SPEC (ratios steer the "
                  "host/device split; local --shards devices are homogeneous "
                  "and split evenly)", file=sys.stderr)
            return 1
        from .parallel.multihost import read_ratio_file

        n_ratio = shard[1] if shard else len(args.devices.split("+"))
        try:
            ratios = read_ratio_file(args.ratio_file, n_ratio)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    import torch

    device = None
    if args.devices:
        if args.device is not None:
            print(f"error: --device and -t are mutually exclusive (-t {args.devices} "
                  "names the devices of the run)", file=sys.stderr)
            return 1
    else:
        try:
            device = torch.device(args.device or "cuda")
        except RuntimeError as e:
            p.error(f"--device {args.device}: {e}")
        if device.type == "cuda" and not torch.cuda.is_available():
            print("error: no CUDA device is available; pass --device cpu to run the "
                  "plain torch path on the CPU", file=sys.stderr)
            return 1

    from .pipeline import PipelineConfig

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
    if args.sync_timeout is not None:
        cfg_kwargs["sync_timeout"] = args.sync_timeout
    mode = Mode.SEMI_GLOBAL if args.semi_global else Mode.GLOBAL
    config = PipelineConfig(**cfg_kwargs)
    return args, scoring, mode, config, shard, ratios, device, query, database


def align_main(argv=None) -> int:
    with Span("cli"):  # the checks and the line-format probes
        checked = _align_checks(argv)
    if isinstance(checked, int):
        return checked
    args, scoring, mode, config, shard, ratios, device, query, database = checked
    from .banded_pipeline import run_banded
    from .pipeline import run_alignment

    profile_cm = (_profiler(args.profile, args.profile_python) if args.profile
                  else contextlib.nullcontext())
    try:
        with profile_cm:  # a torch.profiler trace around the whole run (--profile)
            if args.devices:
                from .parallel.hetero import hetero_engines, run_hetero

                engines = hetero_engines(scoring, mode, config, args.devices,
                                         threshold=args.threshold)
                stats, _ = run_hetero(
                    engines, query, database, args.result, config,
                    ratios=ratios, dynamic=args.dynamic,
                    write_dtype=np.int8 if args.threshold is not None else np.int16,
                )
            elif args.threshold is not None:
                stats = run_banded(query, database, args.result, args.threshold, config,
                                   shard=shard, shard_ratios=ratios, resume=args.resume,
                                   dynamic=args.dynamic, sync_dir=args.sync_dir,
                                   device=device)
            else:
                stats = run_alignment(query, database, args.result, scoring, mode, config,
                                      shard=shard, shard_ratios=ratios, resume=args.resume,
                                      dynamic=args.dynamic, sync_dir=args.sync_dir,
                                      device=device)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    with Span("cli"):  # the stats and the report
        if shard is not None:
            stats, meta = stats
            meta.save(args.result + ".meta.json")
        if args.stats_json:
            with open(args.stats_json, "w") as f:
                f.write(stats.to_json() + "\n")
        if not args.quiet:
            print(f"score is {scoring.match}, {scoring.mismatch}, {scoring.gap}")
            print(stats.report())
    return 0


def convert_main(argv=None) -> int:
    """``bgsa-torch-convert``: ``bgsa-convert`` over the port's own ``io``
    modules (``-f`` FASTA, ``-q`` FASTQ, ``-r`` result to text, ``-o``
    output)."""
    p = argparse.ArgumentParser(prog="bgsa-torch-convert", description=convert_main.__doc__)
    p.add_argument("-f", dest="fasta", help="convert FASTA file")
    p.add_argument("-q", dest="fastq", help="convert FASTQ file")
    p.add_argument("-r", dest="result", help="convert binary result file to text")
    p.add_argument("-o", dest="output", default="convert_result.txt", help="output file")
    p.add_argument("--banded", action="store_true",
                   help="force int8 banded scores (normally inferred from the "
                        "file size; the reference needs a per-family binary)")
    args = p.parse_args(argv)

    from .io import fastx
    from .io import result as result_io

    try:
        if args.fasta:
            fastx.convert_fasta(args.fasta, args.output)
        elif args.fastq:
            fastx.convert_fastq(args.fastq, args.output)
        elif args.result:
            dtype = np.int8 if args.banded else None  # None -> infer from size
            result_io.convert_result(args.result, args.output, write_dtype=dtype)
        else:
            p.error("one of -f / -q / -r is required")
    except (ValueError, OSError) as e:
        p.error(str(e))
    return 0


def merge_main(argv=None) -> int:
    """Merge per-host shard files (from ``align --host I:N``, of either
    package) into one reference-layout result file (+ .info)."""
    p = argparse.ArgumentParser(prog="bgsa-torch-merge", description=merge_main.__doc__)
    p.add_argument("shards", nargs="+", help="shard files, any order")
    p.add_argument("-o", dest="output", required=True, help="merged result file")
    p.add_argument("--banded", action="store_true",
                   help="shards hold int8 banded scores (only needed for shards "
                        "written before the dtype was recorded in the sidecar)")
    args = p.parse_args(argv)

    from .parallel.multihost import ShardMeta, merge_shards

    try:
        metas = [ShardMeta.load(s + ".meta.json") for s in args.shards]
        # Host-id completeness, cross-run consistency, path/meta pairing and
        # dtype equality across sidecars are merge_shards' own validation;
        # --banded only overrides legacy sidecars that predate the dtype field.
        dtype = np.dtype(np.int8) if args.banded else np.dtype(metas[0].dtype)
        merge_shards(args.output, list(args.shards), metas, write_dtype=dtype)
    except (ValueError, OSError, TypeError) as e:
        # TypeError: np.dtype() on a garbage dtype string from a sidecar
        p.error(str(e))
    return 0


def main(argv=None) -> int:
    """``python -m bgsa_tpu_torch.cli [align|convert|merge] ...`` dispatcher."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "convert":
        return convert_main(argv[1:])
    if argv and argv[0] == "merge":
        return merge_main(argv[1:])
    if argv and argv[0] == "align":
        argv = argv[1:]
    return align_main(argv)


if __name__ == "__main__":
    sys.exit(main())
