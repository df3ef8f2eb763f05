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
    # source listed for the build exists
    names = sorted(os.listdir(build.CSRC_DIR))
    assert "banded_common.cuh" in names
    assert all(s in names for s in build.SOURCES)
    assert set(build.SOURCES) == {n for n in names if n.endswith(".cu")}
