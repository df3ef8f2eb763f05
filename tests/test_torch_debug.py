"""bgsa_tpu_torch.debug against bgsa_tpu.debug, on the CPU.

The port's formatters equal bgsa_tpu's on the same words, and the kprint
fixture's plain version prints ``probe 0`` and returns its input, as the
interpret-mode Pallas fixture of tests/test_round2_fixes.py does with
``bgsa_tpu.debug.kprint``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bgsa_tpu import debug as jax_debug
from bgsa_tpu_torch import debug

WORDS = [0, 1, 0b1011, 0x80000000, 0xFFFFFFFF, 0x12345678]


@pytest.mark.parametrize("word", WORDS)
@pytest.mark.parametrize("bits,lsb_first", [(32, True), (32, False), (8, True), (4, False)])
def test_format_binary_matches_bgsa_tpu(word, bits, lsb_first):
    assert debug.format_binary(word, bits, lsb_first) == jax_debug.format_binary(
        word, bits, lsb_first)


@pytest.mark.parametrize("bits", [4, 31, 32])
def test_format_words_matches_bgsa_tpu(bits):
    words = np.array(WORDS, dtype=np.uint32).reshape(2, 3)
    assert debug.format_words(words, bits) == jax_debug.format_words(words, bits)
    assert debug.format_words(words, bits, sep=",") == jax_debug.format_words(words, bits, ",")


@pytest.mark.parametrize("max_lanes", [2, 8, 16, 64])
def test_format_lanes_matches_bgsa_tpu(max_lanes):
    tile = np.arange(2 * 16, dtype=np.uint32).reshape(2, 16) * 0x01010101
    assert debug.format_lanes(tile, max_lanes) == jax_debug.format_lanes(tile, max_lanes)


def test_plain_kprint_probe_prints_like_the_interpret_mode_fixture(capfd):
    def kernel(x_ref, o_ref):
        jax_debug.kprint("probe {}", x_ref[0, 0])
        o_ref[...] = x_ref[...]

    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    want = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
                          interpret=True)(jnp.asarray(x))
    jax_lines = capfd.readouterr().out.splitlines()
    before = debug.LAUNCHES
    got = debug.kprint_probe(torch.from_numpy(x))
    assert debug.LAUNCHES == before  # the plain version on the CPU
    lines = capfd.readouterr().out.splitlines()
    assert lines == ["probe 0"] and "probe 0" in jax_lines
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_kprint_probe_copies():
    x = torch.full((3, 5), 7, dtype=torch.int32)
    out = debug.kprint_probe_ref(x)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("bad", ["dtype", "rank", "empty", "device"])
def test_kprint_probe_rejects_what_its_kernel_does_not_take(bad):
    x = {"dtype": torch.zeros((8, 128), dtype=torch.int64),
         "rank": torch.zeros(8, dtype=torch.int32),
         "empty": torch.zeros((0, 128), dtype=torch.int32),
         "device": torch.zeros((8, 128), dtype=torch.int32, device="meta")}[bad]
    with pytest.raises(ValueError):
        debug.kprint_probe(x)


def test_main_on_the_cpu_prints_the_probe_and_a_result(capsys):
    assert debug.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    result = json.loads(lines[-1])
    assert lines[:-1] == ["probe 0"] * result["probe_lines"]
    assert result == {"device": "cpu", "launches": 0, "out_equals_x": True, "probe_lines": 1}


def test_main_without_a_gpu_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert debug.main([]) == 1
    assert "--device cpu" in capsys.readouterr().err


def test_the_reference_probes_plain_versions():
    x = torch.arange(3 * 5, dtype=torch.int32).reshape(3, 5)
    out = debug.copy_probe(x)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    assert debug.empty_probe("cpu") is None
    with pytest.raises(ValueError):
        debug.copy_probe(torch.zeros((8, 128), dtype=torch.int64))
    with pytest.raises(ValueError):
        debug.empty_probe("meta")


def test_the_reference_probes_are_built_and_declared():
    import os
    import re

    from bgsa_tpu_torch.ops import build

    with open(os.path.join(build.CSRC_DIR, "kprint_probe.cu")) as f:
        text = f.read()
    for fn, argc in (("bgsa_copy_probe", 4), ("bgsa_empty_probe", 1)):
        params = re.search(rf"^int {fn}\(([^)]*)\)", text, re.M).group(1)
        assert params.count(",") + 1 == argc == len(build._SIGNATURES[fn]), fn
    # the copy is the fixture's loop without the print; the empty kernel is empty
    body = text.split("copy_probe_kernel(", 1)[1].split("}\n", 1)[0]
    assert "BGSA_KPRINT" not in body and "out[i] = x[i];" in body
    assert "__global__ void empty_probe_kernel() {}" in text
