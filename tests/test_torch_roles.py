"""The port's multi-host roles (``--host``, ``-R``, ``-D``, ``--resume``) and
its merge and convert CLIs against ``bgsa_tpu`` on the CPU.

The cases of ``tests/test_multihost.py`` that ``test_torch_host.py`` does not
cover, of ``tests/test_dynamic.py`` and of ``tests/test_resume_robustness.py``
on the port: roles run in-process and as concurrent ``python -m
bgsa_tpu_torch.cli align ... --device cpu`` subprocesses. Tolerance 0: each
role's shard and sidecar equal ``bgsa_tpu``'s for the same role, merged
results convert equal to the single-host run's, and each package's merge
takes the other's shards.
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from bgsa_tpu import cli as jax_cli
from bgsa_tpu import pipeline as jax_pipeline
from bgsa_tpu.banded_pipeline import run_banded as jax_run_banded
from bgsa_tpu.parallel import multihost as jax_multihost
from bgsa_tpu_torch import cli
from bgsa_tpu_torch import pipeline as port
from bgsa_tpu_torch.banded_pipeline import run_banded
from bgsa_tpu_torch.io import result as result_io
from bgsa_tpu_torch.io import seqfile
from bgsa_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read(path):
    with open(path, "rb") as f:
        return f.read()


def dataset(tmp_path, rng, Q, m, S, n, planted=0):
    q = rng.integers(0, 4, size=(Q, m))
    s = rng.integers(0, 4, size=(S, n))
    s[:planted, :m] = q[0]  # some passing reads for the banded filter
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    return qp, sp


def converted(path, **kw):
    out = path + ".txt"
    result_io.convert_result(path, out, **kw)
    return read(out)


def jax_single(tmp_path, qp, sp, k=None, **cfg):
    """bgsa_tpu's single-host run, converted."""
    config = jax_pipeline.PipelineConfig(backend="xla", **cfg)
    path = str(tmp_path / "jax_single.bin")
    if k is None:
        jax_pipeline.run_alignment(qp, sp, path, config=config)
        return converted(path, ref_bucket_count=config.ref_bucket_count)
    jax_run_banded(qp, sp, path, k, config)
    return converted(path, write_dtype=np.int8, ref_bucket_count=config.ref_bucket_count)


def port_roles(tmp_path, qp, sp, n_hosts, cfg, k=None, ratios=None, prefix="shard"):
    paths, metas = [], []
    for h in range(n_hosts):
        path = str(tmp_path / f"{prefix}{h}.bin")
        kw = dict(shard=(h, n_hosts), shard_ratios=ratios, device="cpu")
        if k is None:
            _, meta = port.run_alignment(qp, sp, path, config=cfg, **kw)
        else:
            _, meta = run_banded(qp, sp, path, k, cfg, **kw)
        paths.append(path)
        metas.append(meta)
    return paths, metas


@pytest.mark.parametrize("k", [None, 8], ids=["myers", "banded"])
def test_port_roles_equal_jax_roles_and_merge_equals_single(tmp_path, rng, k):
    """Two roles in sequence: each shard file and sidecar equal bgsa_tpu's
    for the same role, the port's merge equals bgsa_tpu's merge byte for
    byte, and the merged file converts equal to the single-host run."""
    Q, m, S, n = (5, 30, 700, 40) if k is None else (4, 64, 700, 70)
    qp, sp = dataset(tmp_path, rng, Q, m, S, n, planted=0 if k is None else 40)
    cfg = port.PipelineConfig(bucket_size=256 * (n + 1), ref_bucket_count=3)
    jcfg = jax_pipeline.PipelineConfig(backend="xla", bucket_size=256 * (n + 1),
                                       ref_bucket_count=3)
    paths, metas = port_roles(tmp_path, qp, sp, 2, cfg, k=k)
    jpaths, jmetas = [], []
    for h in range(2):
        path = str(tmp_path / f"jax{h}.bin")
        if k is None:
            _, meta = jax_pipeline.run_alignment(qp, sp, path, config=jcfg, shard=(h, 2))
        else:
            _, meta = jax_run_banded(qp, sp, path, k, jcfg, shard=(h, 2))
        assert read(paths[h]) == read(path)
        assert dataclasses.asdict(metas[h]) == dataclasses.asdict(meta)
        jpaths.append(path)
        jmetas.append(meta)
    dtype = np.int16 if k is None else np.int8
    merged, jmerged = str(tmp_path / "merged.bin"), str(tmp_path / "jmerged.bin")
    multihost.merge_shards(merged, paths, metas, write_dtype=dtype, ref_bucket_count=3)
    jax_multihost.merge_shards(jmerged, jpaths, jmetas, write_dtype=dtype, ref_bucket_count=3)
    assert read(merged) == read(jmerged) and read(merged + ".info") == read(jmerged + ".info")
    assert result_io.read_info(merged + ".info").device_num == 2
    assert converted(merged, write_dtype=dtype, ref_bucket_count=3) == jax_single(
        tmp_path, qp, sp, k=k, bucket_size=256 * (n + 1), ref_bucket_count=3)


@pytest.mark.parametrize("ratios,S,rows,block_counts", [
    ([1e9, 1.0], 700, 512, [[384, 128], [128, 128]]),
    ([1e9, 1.0, 1e9], 700, 512, [[128, 0], [0, 0], [384, 256]]),
    ([1.0, 1.0, 1.0], 1380, 768, [[256, 128], [256, 128], [256, 384]]),
], ids=["minimal-last-host", "zero-middle-host", "tail-slice-over-full-slice"])
def test_port_extreme_ratios_merge_equals_single(tmp_path, rng, ratios, S, rows,
                                                 block_counts):
    """Ratios skewed ~1e9:1: the last host inherits one lane group a bucket,
    more than half of it 'N' pads; a middle host can get nothing at all (an
    empty shard). Equal thirds: the last host's slice of the tail bucket
    (its remainder) is larger than its slice of a full one. Merge + convert
    still equal the single-host run."""
    n, n_hosts = 24, len(ratios)
    qp, sp = dataset(tmp_path, rng, 3, 20, S, n)
    cfg = port.PipelineConfig(bucket_size=rows * (n + 1))
    paths, metas = port_roles(tmp_path, qp, sp, n_hosts, cfg, ratios=ratios)
    counts = seqfile.DatabaseReader(sp, cfg.bucket_size, cfg.v_num).bucket_counts()
    assert metas[-1].extra_counts[-1] == counts[-1][1] == -(S - rows) % 128
    for h in range(n_hosts):
        assert metas[h].block_counts == block_counts[h] == [
            jax_multihost.host_slice(c, n_hosts, h, 128, ratios)[1] for c, _ in counts]
        if not any(block_counts[h]):
            assert os.path.getsize(paths[h]) == 0  # an empty shard
    merged = str(tmp_path / "merged.bin")
    multihost.merge_shards(merged, paths, metas)
    assert converted(merged) == jax_single(tmp_path, qp, sp, bucket_size=rows * (n + 1))


@pytest.mark.parametrize("run", ["single", "roles", "dynamic"])
def test_port_buckets_reach_the_engine_unpadded(tmp_path, rng, monkeypatch, run):
    """Over two shards (lanes of 128 x 2), each scores_packed call gets the
    rows of its bucket, or of this host's slice of it under a skewed -R or
    -D, 'N' lane pads included and nothing more: a multiple of 256, the tail
    not padded to the full bucket. The roles merge equal to the single-host
    run."""
    # buckets of 2,560 and 700 + 68 'N' lane pads; -D slices of 512 (chunk)
    S, n = 3260, 24
    qp, sp = dataset(tmp_path, rng, 3, 20, S, n)
    cfg = port.PipelineConfig(bucket_size=2560 * (n + 1))
    rows = {}
    scores_packed = port.Engine.scores_packed

    def record(self, query_codes, transport, payload, s_len):
        main = payload[0] if isinstance(payload, tuple) else payload
        rows.setdefault(threading.current_thread().name, []).append(main.shape[0])
        return scores_packed(self, query_codes, transport, payload, s_len)

    monkeypatch.setattr(port.Engine, "scores_packed", record)
    kw = dict(config=cfg, devices=["cpu", "cpu"])
    single = str(tmp_path / "single.bin")
    if run == "single":
        port.run_alignment(qp, sp, single, **kw)
        assert rows == {"MainThread": [2560, 768]}
        return
    n_hosts = 2
    paths = [str(tmp_path / f"shard{h}.bin") for h in range(n_hosts)]
    if run == "roles":
        metas = [port.run_alignment(qp, sp, paths[h], shard=(h, n_hosts),
                                    shard_ratios=[3.0, 1.0], **kw)[1]
                 for h in range(n_hosts)]
        names = ["MainThread"] * n_hosts
    else:  # -D roles wait for each other's bucket times: one thread each
        metas = [None] * n_hosts

        def role(h):
            metas[h] = port.run_alignment(qp, sp, paths[h], shard=(h, n_hosts),
                                          dynamic=True, sync_dir=str(tmp_path), **kw)[1]

        threads = [threading.Thread(target=role, args=(h,), name=f"role{h}")
                   for h in range(n_hosts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        names = [t.name for t in threads]
    got = [c for name in dict.fromkeys(names) for c in rows[name]]
    want = [c for m in metas for c in m.block_counts if c]
    assert got == want and all(c % 256 == 0 for c in got)
    assert [sum(m.block_counts[b] for m in metas) for b in range(2)] == [2560, 768]
    merged = str(tmp_path / "merged.bin")
    multihost.merge_shards(merged, paths, metas)
    port.run_alignment(qp, sp, single, **kw)
    assert converted(merged) == converted(single)


@pytest.mark.parametrize("run,warms", [
    ("single", [1]), ("roles", [1, 1]), ("dynamic", [1, 1]), ("resumed", [1]),
    ("resumed-complete", [0]),
], ids=["single", "roles", "dynamic", "resumed", "resumed-complete"])
def test_port_run_warms_once(tmp_path, rng, monkeypatch, run, warms):
    """Engine.warm runs once a run, before the first bucket is scored, in
    every mode that has a bucket left to score: a single host, each --host
    role, each -D role, a resumed truncated run; a resumed run whose buckets
    are all done warms nothing and scores nothing. Each run keeps its bytes."""
    Q, n = 3, 24
    qp, sp = dataset(tmp_path, rng, Q, 20, 700, n)  # buckets of 256, 256, 128
    cfg = port.PipelineConfig(bucket_size=256 * (n + 1))
    full = str(tmp_path / "full.bin")
    port.run_alignment(qp, sp, full, config=cfg, device="cpu")
    calls = {}

    def logged(kind, method):
        def call(self, *args):
            calls.setdefault(threading.current_thread().name, []).append(kind)
            return method(self, *args)
        return call

    monkeypatch.setattr(port.Engine, "warm", logged("warm", port.Engine.warm))
    monkeypatch.setattr(port.Engine, "scores_packed",
                        logged("score", port.Engine.scores_packed))
    paths = [str(tmp_path / f"run{i}.bin") for i in range(len(warms))]
    kw = dict(config=cfg, device="cpu")
    if run.startswith("resumed"):
        shutil.copy(full, paths[0])
        shutil.copy(full + ".info", paths[0] + ".info")
        if run == "resumed":
            with open(paths[0], "r+b") as f:
                f.truncate(256 * Q * 2 + 100)  # a bucket and a half
        kw["resume"] = True
    elif run != "single":
        kw.update(shard=(0, 2), dynamic=run == "dynamic", sync_dir=str(tmp_path))
    errors = []

    def one(i):
        try:
            if "shard" in kw:
                port.run_alignment(qp, sp, paths[i], **{**kw, "shard": (i, 2)})
            else:
                port.run_alignment(qp, sp, paths[i], **kw)
        except BaseException as e:  # noqa: BLE001 — re-raised on the test's thread
            errors.append(e)

    # one thread a run, concurrent: -D roles wait for each other's bucket times
    threads = [threading.Thread(target=one, args=(i,), name=f"run{i}")
               for i in range(len(warms))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    for i, want in enumerate(warms):
        got = calls.get(f"run{i}", [])
        assert got.count("warm") == want
        assert got[:want] == ["warm"] * want and ("score" in got) == bool(want)
    if run.startswith("resumed"):
        assert read(paths[0]) == read(full)
        assert read(paths[0] + ".info") == read(full + ".info")
    elif run != "single":
        merged, _ = merge_roles(tmp_path, paths)
        assert converted(merged) == converted(full)


def test_port_cli_host_roles_merge_both_ways(tmp_path, rng):
    """bgsa-torch-align --host I:2 -R, then bgsa-torch-merge; bgsa-merge takes
    the port's shards and bgsa-torch-merge bgsa-align's, each merge byte-equal
    to the other, and the merged file converts equal to the single run."""
    qp, sp = dataset(tmp_path, rng, 3, 30, 600, 40)
    rfile = str(tmp_path / "ratios.txt")
    with open(rfile, "w") as f:
        f.write("1.0 3.0\n")
    shards, jshards = [], []
    for h in range(2):
        sh, jsh = str(tmp_path / f"sh{h}.bin"), str(tmp_path / f"jsh{h}.bin")
        assert cli.main(["align", "-q", qp, "-d", sp, "-f", sh, "--device", "cpu", "--quiet",
                         "--host", f"{h}:2", "-R", rfile]) == 0
        assert jax_cli.main(["align", "-q", qp, "-d", sp, "-f", jsh, "--backend", "xla",
                             "--quiet", "--host", f"{h}:2", "-R", rfile]) == 0
        assert read(sh) == read(jsh)
        assert json.loads(read(sh + ".meta.json")) == json.loads(read(jsh + ".meta.json"))
        shards.append(sh)
        jshards.append(jsh)
    merges = {}
    for label, main, inputs in (("port of port", cli.main, shards),
                                ("jax of port", jax_cli.main, shards),
                                ("port of jax", cli.main, jshards)):
        out = str(tmp_path / f"{label.replace(' ', '_')}.bin")
        assert main(["merge", *inputs[::-1], "-o", out]) == 0
        merges[label] = read(out) + read(out + ".info")
    assert len(set(merges.values())) == 1
    single = str(tmp_path / "single.bin")
    assert cli.main(["align", "-q", qp, "-d", sp, "-f", single, "--device", "cpu",
                     "--quiet"]) == 0
    assert converted(str(tmp_path / "port_of_port.bin")) == converted(single) == jax_single(
        tmp_path, qp, sp)


def test_port_shard_resume_after_interruption(tmp_path, rng):
    """--host role resume: a truncated shard continues where it left off, to
    bgsa_tpu's shard for the same role."""
    Q, n = 4, 40
    qp, sp = dataset(tmp_path, rng, Q, 30, 1500, n)
    cfg = port.PipelineConfig(bucket_size=256 * (n + 1))
    want = str(tmp_path / "jax.bin")
    jax_pipeline.run_alignment(qp, sp, want, shard=(0, 2), config=jax_pipeline.PipelineConfig(
        backend="xla", bucket_size=256 * (n + 1)))
    full = str(tmp_path / "full.bin")
    port.run_alignment(qp, sp, full, config=cfg, shard=(0, 2), device="cpu")[1].save(
        full + ".meta.json")
    assert read(full) == read(want)

    # a crash: 1.5 buckets' bytes and the sidecar saved incrementally
    counts = seqfile.DatabaseReader(sp, cfg.bucket_size, cfg.v_num).bucket_counts()
    first = multihost.host_slice(counts[0][0], 2, 0, cfg.v_num)[1]
    part = str(tmp_path / "part.bin")
    with open(part, "wb") as f:
        f.write(read(want)[:first * Q * 2 + 100])
    shutil.copy(full + ".meta.json", part + ".meta.json")
    _, meta = port.run_alignment(qp, sp, part, config=cfg, shard=(0, 2), resume=True,
                                 device="cpu")
    assert read(part) == read(want)
    assert len(meta.block_counts) == len(counts)


def test_port_shard_resume_edges(tmp_path, rng):
    """--resume on a role that never ran starts fresh; an orphan shard or a
    shard whose sidecar is gone is refused, not guessed (bgsa_tpu's
    messages)."""
    qp, sp = dataset(tmp_path, rng, 2, 16, 300, 20)
    cfg = port.PipelineConfig(bucket_size=256 * 21)
    p = str(tmp_path / "sh0.bin")
    _, meta = port.run_alignment(qp, sp, p, config=cfg, shard=(0, 2), resume=True,
                                 device="cpu")
    assert sum(meta.block_counts) > 0
    os.unlink(p + ".meta.json")
    with pytest.raises(ValueError, match="sidecar .* is missing") as got:
        port.run_alignment(qp, sp, p, config=cfg, shard=(0, 2), resume=True, device="cpu")
    with pytest.raises(ValueError, match="sidecar .* is missing") as want:
        jax_pipeline.run_alignment(qp, sp, p, config=jax_pipeline.PipelineConfig(
            backend="xla", bucket_size=256 * 21), shard=(0, 2), resume=True)
    assert str(got.value) == str(want.value)
    orphan = str(tmp_path / "orphan.bin")
    with open(orphan, "wb") as f:
        f.write(b"\0" * 100)
    with pytest.raises(ValueError, match="meta.json is missing"):
        port.run_alignment(qp, sp, orphan, config=cfg, shard=(0, 2), resume=True,
                           device="cpu")


def test_port_resume_refuses_changed_ratios(tmp_path, rng):
    """A static role resumed under other -R ratios is refused; the same
    ratios at any scale resume."""
    n = 20
    qp, sp = dataset(tmp_path, rng, 2, 16, 900, n)
    cfg = port.PipelineConfig(bucket_size=256 * (n + 1))
    p = str(tmp_path / "sh0.bin")
    port.run_alignment(qp, sp, p, config=cfg, shard=(0, 2), shard_ratios=[1.0, 2.0],
                       device="cpu")[1].save(p + ".meta.json")
    for ratios in (None, [2.0, 1.0]):
        with pytest.raises(ValueError, match="split ratios"):
            port.run_alignment(qp, sp, p, config=cfg, shard=(0, 2), shard_ratios=ratios,
                               resume=True, device="cpu")
    _, meta = port.run_alignment(qp, sp, p, config=cfg, shard=(0, 2),
                                 shard_ratios=[10.0, 20.0], resume=True, device="cpu")
    assert meta.ratios == [1.0 / 3.0, 2.0 / 3.0]


def test_port_merge_infers_dtype_from_sidecar(tmp_path, rng):
    """Banded (int8) shards merge through bgsa-torch-merge without --banded:
    the sidecar records the dtype."""
    n = 44
    qp, sp = dataset(tmp_path, rng, 3, 40, 500, n, planted=30)
    cfg = port.PipelineConfig(bucket_size=256 * (n + 1))
    paths, metas = port_roles(tmp_path, qp, sp, 2, cfg, k=6)
    for path, meta in zip(paths, metas):
        assert meta.dtype == "int8"
        meta.save(path + ".meta.json")
    merged = str(tmp_path / "merged.bin")
    assert cli.main(["merge", *paths, "-o", merged]) == 0
    assert converted(merged, write_dtype=np.int8) == jax_single(
        tmp_path, qp, sp, k=6, bucket_size=256 * (n + 1))


def test_port_merge_refusals(tmp_path):
    """Merge refuses, as bgsa-merge does: a shard whose size disagrees with
    its sidecar, shards of different runs (exit through argparse), duplicate
    host ids and unpaired paths; out-of-order pairs merge correctly."""
    metas = [multihost.ShardMeta(h, 2, 5, [128], [0], dtype="int16") for h in range(2)]
    paths = []
    for h, meta in enumerate(metas):
        p = str(tmp_path / f"s{h}.bin")
        with open(p, "wb") as f:  # int8-sized payload under an int16 sidecar
            f.write(b"\0" * (128 * 5 * (1 if h else 2)))
        meta.save(p + ".meta.json")
        paths.append(p)
    with pytest.raises(ValueError, match="wrong dtype or truncated"):
        multihost.merge_shards(str(tmp_path / "m.bin"), paths, metas)

    for name, meta in (("a.bin", multihost.ShardMeta(0, 2, 5, [128], [0])),
                       ("b.bin", multihost.ShardMeta(1, 2, 7, [128], [0]))):  # ref_count
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(b"\0" * 10)
        meta.save(p + ".meta.json")
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit):
            main(["merge", str(tmp_path / "a.bin"), str(tmp_path / "b.bin"),
                  "-o", str(tmp_path / "m.bin")])

    dup = [multihost.ShardMeta(0, 2, 5, [128], [0], dtype="int16") for _ in range(2)]
    dpaths = []
    for i, meta in enumerate(dup):
        p = str(tmp_path / f"d{i}.bin")
        with open(p, "wb") as f:
            f.write(b"\0" * (128 * 5 * 2))
        dpaths.append(p)
    with pytest.raises(ValueError, match="hosts 0..1"):
        multihost.merge_shards(str(tmp_path / "m.bin"), dpaths, dup)
    with pytest.raises(ValueError, match="shard paths but"):
        multihost.merge_shards(str(tmp_path / "m.bin"), dpaths[:1], dup)

    good = [multihost.ShardMeta(h, 2, 1, [128], [0], dtype="int16") for h in range(2)]
    gp = []
    for h in range(2):
        p = str(tmp_path / f"g{h}.bin")
        np.full(128, h, np.int16).tofile(p)
        gp.append(p)
    out = str(tmp_path / "g.bin")
    multihost.merge_shards(out, [gp[1], gp[0]], [good[1], good[0]])
    merged = np.fromfile(out, np.int16)
    assert (merged[:128] == 0).all() and (merged[128:] == 1).all()


def test_port_merge_refuses_mixed_databases(tmp_path, rng):
    """Shards of two databases that agree on every per-shard count: the
    sidecar's database subject count catches the mix."""
    qp = str(tmp_path / "q.txt")
    seqfile.write_seq_file(qp, rng.integers(0, 4, size=(2, 16)))
    paths, metas = [], []
    for h, S in ((0, 500), (1, 600)):
        sp = str(tmp_path / f"s{h}.txt")
        seqfile.write_seq_file(sp, rng.integers(0, 4, size=(S, 20)))
        p = str(tmp_path / f"sh{h}.bin")
        _, meta = port.run_alignment(qp, sp, p, shard=(h, 2), device="cpu")
        paths.append(p)
        metas.append(meta)
    with pytest.raises(ValueError, match="database subject count"):
        multihost.merge_shards(str(tmp_path / "m.bin"), paths, metas)


# -- roles as concurrent subprocesses -----------------------------------------


def spawn_role(args, extra_env):
    env = {**os.environ, "PYTHONPATH": "", "OMP_NUM_THREADS": "2", **extra_env}
    return subprocess.Popen(
        [sys.executable, "-m", "bgsa_tpu_torch.cli", "align", *args, "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )


def wait_ok(procs):
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def merge_roles(tmp_path, shards):
    metas = [multihost.ShardMeta.load(p + ".meta.json") for p in shards]
    merged = str(tmp_path / "merged.bin")
    multihost.merge_shards(merged, shards, metas)
    return merged, metas


def test_port_dynamic_roles_rebalance_and_merge(tmp_path, rng):
    """Two concurrent -D roles, host 1 slowed (BGSA_TEST_BUCKET_SLEEP): both
    record one ratio schedule, which a fresh balancer reproduces from the
    published time files (stale files of other runs in the sync dir stay
    invisible), the splits follow it, the merge converts equal to
    bgsa_tpu's single-host run, and a truncated shard resumes byte for byte
    under the varying schedule."""
    Q, n = 4, 40
    qp, sp = dataset(tmp_path, rng, Q, 30, 3300, n)
    bucket_size = 1024 * (n + 1)  # 4 buckets: 3 x 1024 + tail
    for h in range(2):  # stale time files: legacy names and another run's token
        with open(str(tmp_path / f"bgsa.bucket0.host{h}.time"), "w") as f:
            f.write("1000.0\n")
        with open(str(tmp_path / f"bgsa.feedfacefeed.bucket0.host{h}.time"), "w") as f:
            f.write("0.001\n")
    shards = [str(tmp_path / f"sh{h}.bin") for h in range(2)]
    stats = [str(tmp_path / f"st{h}.json") for h in range(2)]
    wait_ok([spawn_role(["-q", qp, "-d", sp, "-f", shards[h], "--host", f"{h}:2", "-D",
                         "--bucket-size", str(bucket_size), "--stats-json", stats[h],
                         "--quiet"],
                        {"BGSA_TEST_BUCKET_SLEEP": "0.15" if h == 1 else "0"})
             for h in range(2)])
    sa, sb = (json.loads(read(p))["dynamic_ratios"] for p in stats)
    assert len(sa) == 4 and sa == sb and sa[0] == [1.0, 1.0]

    merged, metas = merge_roles(tmp_path, shards)
    assert metas[0].block_counts[0] == metas[1].block_counts[0] == 512
    token = multihost.run_token(qp, sp, 2, None, bucket_size)
    assert token == jax_multihost.run_token(qp, sp, 2, None, bucket_size)
    bal = multihost.DynamicBalancer(2)
    ratios = [list(bal.ratios)]
    for b in range(len(metas[0].block_counts) - 1):
        ratios.append(bal.update(multihost.read_bucket_times(
            str(tmp_path), b, 2, timeout=0, token=token)))
    assert sa == ratios
    for b, r in enumerate(ratios):
        total = metas[0].block_counts[b] + metas[1].block_counts[b]
        assert [m.block_counts[b] for m in metas] == multihost.split_counts(total, 2, 128, r)
    assert converted(merged) == jax_single(tmp_path, qp, sp, bucket_size=bucket_size)

    want = read(shards[0])
    part = str(tmp_path / "part.bin")
    with open(part, "wb") as f:
        f.write(want[:sum(metas[0].block_counts[:2]) * Q * 2 + 50])
    shutil.copy(shards[0] + ".meta.json", part + ".meta.json")
    _, meta = port.run_alignment(qp, sp, part, config=port.PipelineConfig(
        bucket_size=bucket_size), shard=(0, 2), resume=True, dynamic=True,
        sync_dir=str(tmp_path), device="cpu")
    assert read(part) == want and meta.block_counts == metas[0].block_counts


def test_port_host_auto_concurrent_roles(tmp_path, rng):
    """--host auto from BGSA_HOST_ID/BGSA_NUM_HOSTS: two concurrent roles
    merge equal to bgsa_tpu's single-host run."""
    qp, sp = dataset(tmp_path, rng, 3, 25, 900, 32)
    shards = [str(tmp_path / f"sh{h}.bin") for h in range(2)]
    wait_ok([spawn_role(["-q", qp, "-d", sp, "-f", shards[h], "--host", "auto", "--quiet"],
                        {"BGSA_HOST_ID": str(h), "BGSA_NUM_HOSTS": "2"}) for h in range(2)])
    merged, _ = merge_roles(tmp_path, shards)
    assert result_io.read_info(merged + ".info").device_num == 2
    assert converted(merged) == jax_single(tmp_path, qp, sp)


def test_port_host_auto_from_torch_distributed(tmp_path, rng, monkeypatch, capsys):
    """Without the environment, --host auto takes an initialized
    torch.distributed group's rank and world size; with neither it exits 1
    naming both sources."""
    import torch.distributed as dist

    qp, sp = dataset(tmp_path, rng, 2, 20, 400, 24)
    for var in ("BGSA_HOST_ID", "BGSA_NUM_HOSTS"):
        monkeypatch.delenv(var, raising=False)
    res = str(tmp_path / "r.bin")
    assert cli.main(["align", "-q", qp, "-d", sp, "-f", res, "--host", "auto", "--device",
                     "cpu", "--quiet"]) == 1
    err = capsys.readouterr().err
    assert "BGSA_HOST_ID and BGSA_NUM_HOSTS" in err and "torch.distributed" in err
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
    assert cli.main(["align", "-q", qp, "-d", sp, "-f", res, "--host", "auto", "--device",
                     "cpu", "--quiet"]) == 0
    meta = multihost.ShardMeta.load(res + ".meta.json")
    assert (meta.host_id, meta.n_hosts) == (1, 2)
    want = str(tmp_path / "jax.bin")
    jax_pipeline.run_alignment(qp, sp, want, config=jax_pipeline.PipelineConfig(backend="xla"),
                               shard=(1, 2))
    assert read(res) == read(want)


def test_port_dynamic_requires_host(tmp_path, rng, capsys):
    qp, sp = dataset(tmp_path, rng, 2, 20, 200, 20)
    assert cli.main(["align", "-q", qp, "-d", sp, "-f", str(tmp_path / "o.bin"), "-D",
                     "--device", "cpu", "--quiet"]) == 1
    got = capsys.readouterr().err
    assert jax_cli.main(["align", "-q", qp, "-d", sp, "-f", str(tmp_path / "o.bin"), "-D",
                         "--quiet"]) == 1
    assert got == capsys.readouterr().err and "-D requires --host I:N or -t SPEC" in got
    with pytest.raises(ValueError, match="dynamic balancing requires shard"):
        port.run_alignment(qp, sp, str(tmp_path / "o.bin"), dynamic=True, device="cpu")


def test_port_dynamic_roles_with_fasta_inputs(tmp_path, rng):
    """-D roles fed FASTA: each process converts to its own temp file, and
    the run token comes from file content, so both roles meet on one
    schedule; the merge converts equal to bgsa_tpu's run on line files."""
    Q, m, S, n = 2, 24, 1200, 30
    q = rng.integers(0, 4, size=(Q, m))
    s = rng.integers(0, 4, size=(S, n))
    bases = np.frombuffer(b"ACGT", np.uint8)
    qp, sp = str(tmp_path / "q.fasta"), str(tmp_path / "s.fasta")
    for path, arr in ((qp, q), (sp, s)):
        with open(path, "w") as f:
            for i, row in enumerate(arr):
                f.write(f">seq{i}\n{bytes(bases[row]).decode()}\n")
    bucket_size = 256 * (n + 1)
    shards = [str(tmp_path / f"sh{h}.bin") for h in range(2)]
    wait_ok([spawn_role(["-q", qp, "-d", sp, "-f", shards[h], "--host", f"{h}:2", "-D",
                         "--bucket-size", str(bucket_size), "--sync-timeout", "30",
                         "--quiet"], {}) for h in range(2)])
    merged, _ = merge_roles(tmp_path, shards)
    lq, ls = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(lq, q)
    seqfile.write_seq_file(ls, s)
    assert converted(merged) == jax_single(tmp_path, lq, ls, bucket_size=bucket_size)


def test_port_dynamic_resume_republishes_lost_time_file(tmp_path, rng):
    """A -D role that crashed after flushing a bucket but before publishing
    its time: resume re-publishes a neutral 1.0 and rebuilds the shard byte
    for byte (one role, n_hosts=1, in-process)."""
    Q, n = 2, 30
    qp, sp = dataset(tmp_path, rng, Q, 20, 2100, n)
    bucket_size = 1024 * (n + 1)
    cfg = port.PipelineConfig(bucket_size=bucket_size)
    full = str(tmp_path / "sh0.bin")
    port.run_alignment(qp, sp, full, config=cfg, shard=(0, 1), dynamic=True,
                       sync_dir=str(tmp_path), device="cpu")[1].save(full + ".meta.json")
    want = read(full)
    meta = multihost.ShardMeta.load(full + ".meta.json")
    token = multihost.run_token(qp, sp, 1, None, bucket_size)
    os.unlink(multihost.bucket_time_path(str(tmp_path), 0, 0, token))
    with open(full, "r+b") as f:
        f.truncate(meta.block_counts[0] * Q * 2 + 10)
    _, meta_r = port.run_alignment(qp, sp, full, config=cfg, shard=(0, 1), resume=True,
                                   dynamic=True, sync_dir=str(tmp_path), device="cpu")
    assert read(full) == want and meta_r.block_counts == meta.block_counts
    with open(multihost.bucket_time_path(str(tmp_path), 0, 0, token)) as f:
        assert float(f.read()) == 1.0


@pytest.mark.parametrize("mode", ["plain", "shard"])
def test_port_resume_after_sigkill(tmp_path, rng, mode):
    """SIGKILL a bgsa-torch-align run mid-bucket (slowed by the test hook),
    resume it, and hold it to bgsa_tpu's uninterrupted run byte for byte."""
    n = 24
    # 12 queries x 12 buckets: a shard outgrows the file buffer (8 KB) after
    # about 3 buckets, so bytes reach the disk long before the run ends
    qp, sp = dataset(tmp_path, rng, 12, 20, 3000, n)
    bucket_size = 256 * (n + 1)
    shard = (0, 2) if mode == "shard" else None
    want = str(tmp_path / "jax.bin")
    jax_pipeline.run_alignment(qp, sp, want, shard=shard, config=jax_pipeline.PipelineConfig(
        backend="xla", bucket_size=bucket_size))

    part = str(tmp_path / "part.bin")
    proc = spawn_role(["-q", qp, "-d", sp, "-f", part, "--bucket-size", str(bucket_size),
                       "--quiet", *(["--host", "0:2"] if shard else [])],
                      {"BGSA_TEST_BUCKET_SLEEP": "0.3"})
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if os.path.exists(part) and os.path.getsize(part) > 0:
            break
        time.sleep(0.05)
    else:
        proc.kill()
        pytest.fail("run never produced output")
    time.sleep(0.45)  # land inside a later bucket
    proc.send_signal(signal.SIGKILL)
    proc.communicate()
    assert 0 < os.path.getsize(part) < os.path.getsize(want), "the kill came too late"

    cfg = port.PipelineConfig(bucket_size=bucket_size)
    port.run_alignment(qp, sp, part, config=cfg, shard=shard, resume=True, device="cpu")
    assert read(part) == read(want)
    if mode == "plain":
        assert read(part + ".info") == read(want + ".info")


@pytest.mark.parametrize("kind", ["result", "banded-result", "fasta", "fastq"])
def test_port_convert_equals_bgsa_convert(tmp_path, rng, kind):
    """bgsa-torch-convert -r/-f/-q writes what bgsa-convert writes."""
    if kind.endswith("result"):
        qp, sp = dataset(tmp_path, rng, 3, 20, 300, 24, planted=20)
        src = str(tmp_path / "r.bin")
        k = ["-k", "4"] if kind == "banded-result" else []
        assert cli.main(["align", "-q", qp, "-d", sp, "-f", src, "--device", "cpu", "--quiet",
                         *k]) == 0
        flags = ["-r", src]
    else:
        src = str(tmp_path / f"s.{kind}")
        with open(src, "w") as f:
            if kind == "fasta":
                f.write(">a\r\nACGT\r\nAC\n>b\nTTTTTT\n")
            else:
                f.write("@a\nACGTAC\n+\n@@@@@@\n@b\nTTTTTT\n+\n!!!!!!\n")
        flags = ["-f" if kind == "fasta" else "-q", src]
    got, want = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    assert cli.main(["convert", *flags, "-o", got]) == 0
    assert jax_cli.main(["convert", *flags, "-o", want]) == 0
    assert read(got) == read(want) and len(read(got)) > 0


def test_port_cli_entry_points_are_installed_scripts():
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    for name, func in (("align", "align_main"), ("convert", "convert_main"),
                       ("merge", "merge_main")):
        assert scripts[f"bgsa-torch-{name}"] == f"bgsa_tpu_torch.cli:{func}"
        assert callable(getattr(cli, func))
    proc = subprocess.run([sys.executable, "-m", "bgsa_tpu_torch.cli", "merge", "--help"],
                          cwd=REPO, env={**os.environ, "PYTHONPATH": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.startswith("usage: bgsa-torch-merge")
