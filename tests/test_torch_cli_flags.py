"""``bgsa-torch-align`` knows every flag of ``bgsa-align``.

The flags of paths the port has not ported parse as ``bgsa-align`` parses
them and are refused with exit 1, naming the ROADMAP item that ports them;
``--backend auto`` runs as a no-op, ``--backend pallas|xla`` is refused.
On the CPU (``--device cpu``), with the repository's sample data.
"""

import os

import pytest

from bgsa_tpu_torch import cli

SAMPLE = ("sample-data/query.txt", "sample-data/subject.txt")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(tmp_path, *flags):
    res = str(tmp_path / "r.bin")
    q, d = (os.path.join(REPO, p) for p in SAMPLE)
    return cli.align_main(["-q", q, "-d", d, "-f", res, "--device", "cpu", "--quiet", *flags]), res


@pytest.mark.parametrize("flags,item", [
    (["-R", "ratios.txt"], "#8b"),
    (["-n", "2"], "#8a"),
    (["--sync-dir", "sync"], "#8b"),
    (["--sync-timeout", "30"], "#8b"),
    (["--profile", "trace"], "#13"),
    (["--profile-python"], "#13"),
], ids=["R", "n", "sync-dir", "sync-timeout", "profile", "profile-python"])
def test_unported_flag_exits_1_naming_its_item(tmp_path, capsys, flags, item):
    rc, res = run(tmp_path, *flags)
    err = capsys.readouterr().err
    assert rc == 1
    assert f"{flags[0]} is not ported yet" in err and f"ROADMAP queue 1 {item}" in err
    assert not os.path.exists(res)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_backend_other_than_auto_exits_1(tmp_path, capsys, backend):
    rc, res = run(tmp_path, "--backend", backend)
    assert rc == 1 and f"--backend {backend} has no counterpart" in capsys.readouterr().err
    assert not os.path.exists(res)


def test_backend_auto_runs_as_without_it(tmp_path):
    rc, res = run(tmp_path, "--backend", "auto")
    assert rc == 0
    plain = tmp_path / "plain"
    plain.mkdir()
    rc2, res2 = run(plain)
    assert rc2 == 0
    with open(res, "rb") as a, open(res2, "rb") as b:
        assert a.read() == b.read()


def test_flag_shapes_follow_bgsa_align(tmp_path, capsys):
    # argparse refuses a bad value before the port's refusal, as bgsa-align does
    with pytest.raises(SystemExit) as e:
        run(tmp_path, "--sync-timeout", "soon")
    assert e.value.code == 2 and "invalid float value" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        run(tmp_path, "--backend", "cuda")
