"""bgsa_tpu_torch.ops.build: failures raise, with the command and its output.

Runs anywhere: the failing compiler is a stand-in script, so no nvcc is
needed to check the error path.
"""

import os
import stat

import pytest

from bgsa_tpu_torch.ops import build


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_failed_build_raises_with_command_and_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'broken.cu(3): error: expected a ;' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    src = tmp_path / "broken.cu"
    src.write_text("int f() { return 1 }\n")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError) as err:
        build.compile_library([str(src)], str(out))
    msg = str(err.value)
    assert "exit code 2" in msg and str(fake) in msg and "sm_90a" in msg
    assert "expected a ;" in msg
    assert not any(p.suffix == ".so" for p in out.iterdir())


def test_library_name_follows_sources(tmp_path, monkeypatch):
    # a cached library is reused only for identical sources and flags
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first, _, _ = build.compile_library([str(src)], str(tmp_path / "out"))
    again, log, seconds = build.compile_library([str(src)], str(tmp_path / "out"))
    assert again == first and (log, seconds) == ("", 0.0)
    src.write_text("// v2\n")
    changed, _, _ = build.compile_library([str(src)], str(tmp_path / "out"))
    assert changed != first and os.path.exists(changed)


def test_library_name_follows_headers(tmp_path, monkeypatch):
    # a header included by a source is part of the cache key: changing it alone
    # must not load the stale library
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src, header = csrc / "k.cu", csrc / "common.cuh"
    src.write_text('#include "common.cuh"\n')
    header.write_text("// v1\n")
    first, _, _ = build.compile_library([str(src)], str(tmp_path / "out"))
    header.write_text("// v2\n")
    changed, _, _ = build.compile_library([str(src)], str(tmp_path / "out"))
    assert changed != first and os.path.exists(changed)


def test_package_sources_are_all_hashed():
    # every kernel source and header of the package is in the key, and every
    # source is built: into the main library or into one library per scheme
    names = sorted(os.listdir(build.CSRC_DIR))
    assert {"banded_common.cuh", "bitpal_common.cuh"} <= set(names)
    assert all(s in names for s in build.SOURCES + build.SCHEME_SOURCES)
    assert not set(build.SOURCES) & set(build.SCHEME_SOURCES)
    assert set(build.SOURCES + build.SCHEME_SOURCES) == {n for n in names if n.endswith(".cu")}


def recording_nvcc(tmp_path):
    """A stand-in nvcc that appends its arguments to a log and creates its -o file."""
    fake, log = tmp_path / "nvcc", tmp_path / "nvcc.log"
    fake.write_text(f'#!/bin/sh\necho "$@" >> {log}\n'
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    return str(fake), log


def test_scheme_library_name_carries_the_scheme(tmp_path, monkeypatch):
    fake, log = recording_nvcc(tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: fake)
    (tmp_path / "csrc").mkdir()  # apart from the log: the digest hashes the source's directory
    src = tmp_path / "csrc" / "bitpal.cu"
    src.write_text("// v1\n")
    out = str(tmp_path / "out")

    def compile_scheme(m, i, g):
        return build.compile_library(
            [str(src)], out, stem="bgsa_bitpal", tag=build.scheme_tag(m, i, g),
            defines=(f"BGSA_M={m}", f"BGSA_I={i}", f"BGSA_G={g}"))

    first, _, _ = compile_scheme(2, -3, -5)
    assert os.path.basename(first).startswith("libbgsa_bitpal-")
    assert first.endswith("-M2_I-3_G-5.so")
    assert "-DBGSA_M=2 -DBGSA_I=-3 -DBGSA_G=-5" in log.read_text()
    other, _, _ = compile_scheme(5, -1, -2)
    assert other != first and other.endswith("-M5_I-1_G-2.so")
    builds = log.read_text().count(" -c ")
    again, stderr, seconds = compile_scheme(2, -3, -5)  # cached: no nvcc runs
    assert (again, stderr, seconds) == (first, "", 0.0)
    assert log.read_text().count(" -c ") == builds == 2


def test_failed_scheme_build_raises(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'bitpal.cu(9): error: static assertion failed' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError) as err:
        build.load_scheme("bitpal_packed", 2, -3, -5)
    msg = str(err.value)
    assert "-DBGSA_M=2" in msg and "bitpal_packed.cu" in msg and "static assertion" in msg
    assert ("bitpal_packed", 2, -3, -5) not in build._scheme_kernels
    with pytest.raises(ValueError, match="no per-scheme kernel"):
        build.load_scheme("myers_semiglobal", 2, -3, -5)


def test_scheme_libraries_are_cached_one_per_kernel_and_scheme(monkeypatch):
    # the recorded decision: the cache mirrors bgsa_tpu's per-scheme growth
    # (one library per kernel and scheme, never per config, never unloaded),
    # with no cap: the mode, word layout and shapes are launch arguments
    builds = []

    def fake_compile(sources, out_dir, *, stem, tag, defines):
        builds.append((stem, tag))
        return f"{out_dir}/lib{stem}-{tag}.so", "", 1.0

    class Lib:
        def __getattr__(self, name):
            fn = (lambda: 8) if name == "bgsa_reg_words" else (lambda: 32)
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "compile_library", fake_compile)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(build, "_scheme_kernels", {})
    monkeypatch.setattr(build, "_scheme_locks", {})
    first = build.load_scheme("bitpal", 2, -3, -5)
    assert build.load_scheme("bitpal", 2, -3, -5) is first and len(builds) == 1
    assert (first.reg_words, first.tile_columns) == (8, 32)
    schemes = [(m, -1, -1 - g) for m in range(1, 5) for g in range(4)]
    for scheme in schemes:
        build.load_scheme("bitpal", *scheme)
        build.load_scheme("bitpal_packed", *scheme)
    assert len(build._scheme_kernels) == 1 + 2 * len(schemes) == len(builds)
    assert ("bgsa_bitpal_packed", "M2_I-1_G-2") in builds


def test_importing_the_port_builds_nothing():
    import bgsa_tpu_torch.api  # noqa: F401
    import bgsa_tpu_torch.banded_pipeline  # noqa: F401
    import bgsa_tpu_torch.cli  # noqa: F401
    import bgsa_tpu_torch.debug  # noqa: F401
    import bgsa_tpu_torch.ops.banded_packed_pair  # noqa: F401
    import bgsa_tpu_torch.ops.banded_pair  # noqa: F401
    import bgsa_tpu_torch.ops.bitpal  # noqa: F401
    import bgsa_tpu_torch.ops.bitpal_packed  # noqa: F401
    import bgsa_tpu_torch.pipeline  # noqa: F401
    import bgsa_tpu_torch.scripts.exp_banded_packed_pair  # noqa: F401
    import bgsa_tpu_torch.scripts.exp_banded_pair  # noqa: F401
    import bgsa_tpu_torch.scripts.gpu_parity  # noqa: F401

    assert build._kernels is None and build._scheme_kernels == {}


def test_the_paired_query_and_kprint_sources_are_built():
    new = {"banded_pair.cu": ("bgsa_banded_stream_pair", "bgsa_banded_probe"),
           "banded_packed_pair.cu": ("bgsa_banded_packed_pair", "bgsa_banded_packed_probe"),
           "kprint_probe.cu": ("bgsa_kprint_probe",)}
    assert set(new) <= set(build.SOURCES)
    for source, entry_points in new.items():
        with open(os.path.join(build.CSRC_DIR, source)) as f:
            text = f.read()
        assert all(f"int {fn}(" in text and fn in build._SIGNATURES for fn in entry_points)


def test_every_scheme_signature_matches_its_c_definition():
    # the per-scheme libraries' entry points, as test below for the main one
    import re

    for kernel, argtypes in build._SCHEME_SIGNATURES.items():
        with open(os.path.join(build.CSRC_DIR, f"{kernel}.cu")) as f:
            text = f.read()
        params = re.search(rf"^int bgsa_{kernel}\(([^)]*)\)", text, re.M).group(1)
        assert params.count(",") + 1 == len(argtypes), kernel
        assert re.search(r"^int bgsa_tile_columns\(\)", text, re.M), kernel


def test_every_signature_matches_its_c_definition():
    # ctypes passes each argument as declared: a count that differs from the
    # C definition's shifts every argument after it
    import re

    defined = {}
    for name in build.SOURCES:
        with open(os.path.join(build.CSRC_DIR, name)) as f:
            for fn, params in re.findall(r"^int (bgsa_\w+)\(([^)]*)\)", f.read(), re.M):
                defined[fn] = 0 if not params.strip() else params.count(",") + 1
    for fn, argtypes in build._SIGNATURES.items():
        assert defined[fn] == len(argtypes), fn


PTXAS_LOG = """ptxas info    : Compiling entry function '_Z3fooPi' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPi
    16 bytes stack frame, 20 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers, 352 bytes cmem[0]
"""


def test_ptxas_frames_reads_each_function():
    assert build.ptxas_frames(PTXAS_LOG) == {"_Z3fooPi": (16, 20, 12), "_Z3barv": (0, 0, 0)}
    assert build.ptxas_frames("") == {}


def test_a_cached_library_keeps_its_ptxas_report(tmp_path, monkeypatch):
    # the spill check reads the report of a library loaded from the cache too
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'ptxas info    : Used 9 registers' >&2\n"
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "k.cu"
    src.write_text("// v1\n")
    out = str(tmp_path / "out")
    path, log, seconds = build.compile_library([str(src)], out)
    assert "Used 9 registers" in log and seconds > 0
    with open(path + ".log") as f:
        assert f.read() == log
    assert build.compile_library([str(src)], out) == (path, log, 0.0)
    os.unlink(path + ".log")  # a library without its report is built again
    again, log2, seconds = build.compile_library([str(src)], out)
    assert again == path and log2 == log and seconds > 0
