"""bgsa_tpu_torch.roofline against scripts/roofline.py and the JAX kernels.

Every operation-count constant of the port equals the count that
scripts/roofline.py's jaxpr method (``count_alu``) gives for the JAX column
function, the int-peak plain version equals ``_peak_kernel`` run in
interpret mode, the bound arithmetic holds on a worked shape, and the SASS
reader finds each kind of column loop in listings written as cuobjdump
prints them, and counts one column of it per pipe.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bgsa_tpu.ops import banded, bitpal
from bgsa_tpu_torch import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_jax_roofline():
    spec = importlib.util.spec_from_file_location(
        "jax_roofline", os.path.join(REPO, "scripts", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rl = load_jax_roofline()
Q_LEN, S_LEN, K = roofline.BANDED_GEOMETRY


def ops_bitpal_unpacked(W, word_bits=32):
    """count_alu of bitpal._bitpal_column, (2,-3,-5), as ops_bitpal_packed
    counts the packed column."""
    p = bitpal.BitpalParams(2, -3, -5)
    vals = list(p.values)

    def col(flat):
        planes = {v: [flat[i, w] for w in range(W)] for i, v in enumerate(vals)}
        new = bitpal._bitpal_column(planes, [flat[len(vals), w] for w in range(W)], p,
                                    word_bits)
        return jnp.stack([jnp.stack(new[v]) for v in vals])

    flat = jnp.zeros((len(vals) + 1, W) + rl.TILE, jnp.uint32)
    return rl.count_alu(jax.make_jaxpr(col)(flat).jaxpr)


def ops_banded_dual():
    """count_alu of the dual kernel's head column (_stream2_column)."""
    h, band_down, max_err = banded._geometry(Q_LEN, S_LEN, K)

    def col(streams, t, c, chk, *state):
        return banded._stream2_column(
            t, state, c, lambda cc, w: streams[0, cc, w], lambda cc, w: streams[1, cc, w],
            k=K, m=Q_LEN, band_down=band_down, max_err=max_err, chk=chk)

    st = jnp.zeros((2, 5, 10) + rl.TILE, jnp.uint32)
    z, zi = jnp.zeros(rl.TILE, jnp.uint32), jnp.zeros(rl.TILE, jnp.int32)
    one = jnp.int32(1)
    return rl.count_alu(jax.make_jaxpr(col)(st, jnp.int32(4), one, one, z, z, z, z, zi,
                                            zi).jaxpr)


def ops_banded_peq():
    """count_alu of the Peq-carry column (_banded_column)."""
    h, band_down, max_err = banded._geometry(Q_LEN, S_LEN, K)

    def col(t, c, chk, bits, *state):
        return banded._banded_column(t, state, c, bits, k=K, m=Q_LEN, band_down=band_down,
                                     max_err=max_err, chk=chk)

    planes = jnp.zeros((5,) + rl.TILE, jnp.uint32)
    z, zi = jnp.zeros(rl.TILE, jnp.uint32), jnp.zeros(rl.TILE, jnp.int32)
    one = jnp.int32(1)
    return rl.count_alu(jax.make_jaxpr(col)(jnp.int32(40), one, one, planes, planes, planes,
                                            z, z, z, z, zi, zi).jaxpr)


WORD_COUNTERS = {
    "myers_semiglobal": rl.ops_myers_fullword,
    "myers_global": rl.ops_myers_31bit,
    "bitpal_packed": lambda W: rl.ops_bitpal_packed(W)[0],
    "bitpal": ops_bitpal_unpacked,
}


@pytest.mark.parametrize("W", [1, 5, 17])
@pytest.mark.parametrize("name", list(roofline.WORD_OPS))
def test_word_kernel_ops_equal_jaxpr_count(name, W):
    per_word, per_column, _ = roofline.WORD_OPS[name]
    assert per_word * W + per_column == WORD_COUNTERS[name](W)


@pytest.mark.parametrize("name", list(roofline.BANDED_OPS))
def test_banded_ops_equal_jaxpr_count(name):
    counters = {
        "banded_stream": lambda: rl.ops_banded_stream(Q_LEN, S_LEN, K),
        "banded_stream_dual": ops_banded_dual,
        "banded": ops_banded_peq,
        "banded_stream_packed": lambda: rl.ops_banded_packed(Q_LEN, S_LEN, K)[0],
    }
    assert roofline.BANDED_OPS[name] == counters[name]()
    assert rl.ops_banded_packed(Q_LEN, S_LEN, K)[1] == roofline.PACKED_LANES


def test_peak_ops_per_iteration_matches_jax():
    assert roofline.PEAK_OPS_PER_CHAIN_ITER == rl.PEAK_OPS_PER_CHAIN_ITER


@pytest.mark.parametrize("chains,steps,unroll", [(1, 1, 1), (2, 3, 2), (8, 2, 4)])
def test_int_peak_ref_matches_pallas_interpret(chains, steps, unroll):
    import functools

    rows = 8
    x = (np.arange((chains + 1) * rows * 128, dtype=np.uint32)
         .reshape(chains + 1, rows, 128) | 1)
    x[:, 0, :4] = [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0]  # carries and the sign bit
    want = np.asarray(pl.pallas_call(
        functools.partial(rl._peak_kernel, steps=steps, unroll=unroll, chains=chains),
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.uint32), interpret=True,
    )(jnp.asarray(x)))
    xt = torch.from_numpy(x.reshape(chains + 1, -1).view(np.int32))
    before = roofline.LAUNCHES
    got = roofline.int_peak(xt, steps=steps, unroll=unroll)
    assert roofline.LAUNCHES == before  # the plain version on the CPU
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.reshape(-1))


def test_peak_inputs_are_roofline_py_inputs():
    x = roofline.peak_inputs(3, 256, "cpu")
    want = np.arange(4 * 256, dtype=np.uint32).reshape(4, 256) | 1
    np.testing.assert_array_equal(x.numpy().view(np.uint32), want)


def test_bound_arithmetic_worked_shape():
    # the Myers bench line: Q=40, m=500, S=32768, n=500 -> W=16 full words;
    # 326 ops a column = 20 x 16 + 6
    ops = roofline.word_kernel_ops("myers_semiglobal", 40, 500, 32768, 500)
    assert ops == 326 * 40 * 500 * 32768
    assert roofline.ops_per_cell("myers_semiglobal", 500) == pytest.approx(326 / 500)
    peak = 1e13  # ops/s
    eq_bytes = 5 * 16 * 32768 * 4
    ms, by = roofline.bound(ops, eq_bytes + 40 * 32768 * 4, peak)
    assert by == "operations" and ms == pytest.approx(ops / peak * 1e3)
    # a byte-bound case: few ops on many bytes
    ms, by = roofline.bound(1e6, 3.35e9, peak)
    assert by == "bytes" and ms == pytest.approx(1.0)
    # 31-bit words: 17 words of 23 ops + 7
    assert roofline.word_kernel_ops("myers_global", 1, 1, 1, 500) == 23 * 17 + 7


def test_banded_ops_count_live_columns():
    live = [10] * 17 + [4] * 133  # 150 columns, lanes dying after column 17
    total = sum(live)
    assert roofline.banded_ops("banded_stream", live) == 47 * total
    assert roofline.banded_ops("banded", live) == 57 * total
    assert roofline.banded_ops("banded_stream_packed", live) == pytest.approx(67 * total / 3)
    # the dual kernel loads two streams for columns t <= 2k, one after
    assert roofline.banded_ops("banded_stream_dual", live) == 52 * 170 + 47 * (total - 170)


def test_live_columns_from_the_plain_version():
    from bgsa_tpu_torch import pack
    from bgsa_tpu_torch.ops import banded as bo

    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, size=(2, 100)).astype(np.int32)
    s = rng.integers(0, 4, size=(9, 100)).astype(np.int32)
    s[0] = q[0]  # one pair that never goes over budget
    stream = pack.pack_banded_stream(torch.from_numpy(s), 4, 100)
    live = []
    out = bo.banded_stream_ref(stream, torch.from_numpy(q), q_len=100, s_len=100, k=4,
                               live=live)
    assert len(live) == 100 and live[0] == 18
    assert live[-1] == int((out < 127).sum())  # the survivors run every column
    assert all(a >= b for a, b in zip(live, live[1:]))


@pytest.mark.parametrize("bad", ["rank", "dtype", "rows", "unroll"])
def test_int_peak_rejects_bad_inputs(bad):
    x = torch.ones((3, 16), dtype=torch.int32)
    kw = dict(steps=1, unroll=1)
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x = x.long()
    elif bad == "rows":
        x = x[:1]
    else:
        kw["unroll"] = 0
    with pytest.raises(ValueError):
        roofline.int_peak(x, **kw)


def test_derived_peak():
    assert roofline.derived_int32_peak(1980.0, 132) == pytest.approx(132 * 64 * 1.98e9)
    assert roofline.derived_int32_peak(1755.0, 114) == pytest.approx(114 * 64 * 1.755e9)


# -- the instruction bound, on SASS listings written as cuobjdump prints them --


def listing(name, body):
    """A cuobjdump -sass function listing; body: (guard, instruction) rows,
    16 bytes apart from address 0, ``@label`` in an operand replaced by the
    address of the row holding that label (the row's third field)."""
    rows = [row if len(row) == 3 else (*row, None) for row in body]
    where = {label: 16 * i for i, (_, _, label) in enumerate(rows) if label}
    lines = [f"\t\tFunction : {name}", "\t.headerflags\t@\"EF_CUDA_SM90\""]
    for i, (guard, text, _) in enumerate(rows):
        for label in sorted(where, key=len, reverse=True):  # "@hw" before "@h"
            text = text.replace(f"@{label}", f"{where[label]:#x}")
        lines.append(f"        /*{16 * i:04x}*/ {guard:>18} {text} ;  /* 0x0 */")
        lines.append("                                          /* 0x0 */")
    return "\n".join(lines) + "\n"


def word_kernel(maxw):
    """A column loop as myers_regs<MAXW> compiles it: the query code from
    shared memory, then MAXW guarded word copies of 3 instructions."""
    body = [("", "S2R R0, SR_TID.X"), ("", "LDS.U8 R45, [R45+UR9]", "top")]
    for j in range(maxw):
        body += [("", f"ISETP.GE.AND P0, PT, R46, {j + 1:#x}, PT"), ("@!P0", f"BRA @g{j}"),
                 ("", "LDG.E.CONSTANT R28, desc[UR10][R28.64]"),
                 ("", "LOP3.LUT R31, R47, R20, RZ, 0xc0, !PT"),
                 ("", "IMAD.SHL.U32 R48, R31, 0x2, RZ", f"g{j}")]
    body += [("", "IADD3 R2, R2, R31, -R30"), ("@!P1", "BRA @top"), ("", "EXIT")]
    return body


def test_sass_word_kernel_counts_every_instruction_of_its_column_loop():
    text = listing("_ZN4anon10myers_regsILi2EEEvPKj", word_kernel(2))
    text += listing("_ZN4anon10myers_regsILi1EEEvPKj", word_kernel(1))
    functions = roofline.sass_functions(text)
    assert len(functions) == 2
    ins = roofline.find_function(functions, "myers_regsILi2E")
    per = roofline.column_instructions(ins, roofline.SASS_SPECS["myers_semiglobal"])
    # LDS + 2 x (ISETP, BRA, LDG, LOP3, IMAD) + IADD3 + back edge
    assert per == {"issue": 13, "alu": 2 * 2 + 1, "fma": 2}
    with pytest.raises(ValueError, match="2 SASS functions"):
        roofline.find_function(functions, "myers_regs")


def banded_kernel():
    """Two column loops (a head loop and a batch loop) as the banded kernels
    compile them: a code check that skips the window on N, and in the head
    loop a second branch that the shortest path may take."""
    body = [("", "MOV R1, c[0x0][0x28]")]
    # head loop: one column a trip
    body += [("", "LDG.E.U8.CONSTANT R9, desc[UR18][R14.64]", "h"),
             ("", "ISETP.GT.U32.AND P1, PT, R9, 0x4, PT"), ("@P1", "BRA @hw"),
             ("", "LDG.E.CONSTANT R23, desc[UR18][R24.64]"), ("", "SHF.R.W.U32 R9, R9, UR11, R8"),
             ("", "UISETP.GT.AND UP1, UPT, UR4, UR18, UPT", "hw"), ("@P3", "BRA @hs"),
             ("", "LOP3.LUT R22, R9, UR5, RZ, 0xc0, !PT"),
             ("", "LOP3.LUT R2, R9, UR5, RZ, 0xc0, !PT"),
             ("", "IMAD.X R20, R5, 0x1, R20, P1", "hs"),
             ("", "LDG.E.U8.CONSTANT R18, desc[UR18][R16.64]"), ("@!P2", "BRA @h")]
    # batch loop: two columns a trip, 8 instructions each
    body += [("", "LDG.E.U8.CONSTANT R9, desc[UR18][R14.64]", "b"),
             ("", "ISETP.GT.U32.AND P1, PT, R9, 0x4, PT"), ("@P1", "BRA @bw"),
             ("", "LOP3.LUT R22, R9, UR5, RZ, 0xc0, !PT"),
             ("", "LDG.E.U8.CONSTANT R18, desc[UR18][R16.64]", "bw"),
             ("", "LDG.E.U8.CONSTANT R8, desc[UR18][R14.64+0x1]"),
             ("", "ISETP.GT.U32.AND P2, PT, R8, 0x4, PT"), ("@P2", "BRA @bv"),
             ("", "LOP3.LUT R22, R8, UR5, RZ, 0xc0, !PT"),
             ("", "LDG.E.U8.CONSTANT R19, desc[UR18][R16.64+0x1]", "bv"),
             ("", "IADD3 R14, P3, R14, 0x2, RZ"), ("", "IADD3 R16, P4, R16, 0x2, RZ"),
             ("", "IMAD.X R15, RZ, RZ, R15, P3"), ("", "VIADD R7, R7, 0x1"),
             ("", "UIADD3 UR10, UR10, 0x2, URZ"), ("@!P3", "BRA @b"), ("", "EXIT")]
    return body


def test_sass_banded_kernel_takes_the_shortest_path_with_code_checks_falling_through():
    name = "_ZN4anon20banded_stream_kernelILb0EEEv"
    ins = roofline.sass_functions(listing(name, banded_kernel()))[name]
    per = roofline.column_instructions(ins, roofline.SASS_SPECS["banded_stream"])
    # head: 12 instructions; the code check falls through, @P3 skips two LOP3s
    # -> 10 issued, 2 ALU (ISETP, SHF), 1 FMA; batch: 16 a trip over 2
    # columns -> 8 issued, ALU (2 ISETP, 2 LOP3, 2 IADD3) / 2 = 3, FMA 1 / 2;
    # each pipe takes the cheaper loop
    assert per == {"issue": 8, "alu": 2, "fma": 0.5}
    every = roofline.SassSpec("banded_stream_kernelILb0E", "LDG.E.U8.CONSTANT", 2, every=True)
    # every branch falling through: the head loop's 12, the batch loop's 8
    assert roofline.column_instructions(ins, every) == {"issue": 8, "alu": 3, "fma": 0.5}


def test_sass_nested_word_loop_counts_its_trips():
    body = [("", "LDS.U8 R122, [R40+UR4]", "c"), ("", "LOP3.LUT R1, R2, R3, RZ, 0xc0, !PT"),
            ("", "LDG.E R5, desc[UR4][R6.64]", "w"), ("", "IMAD R5, R5, 0x2, RZ"),
            ("", "SHF.L.U32 R5, R5, 0x1, RZ"), ("", "STG.E desc[UR4][R6.64], R5"),
            ("@!P1", "BRA @w"), ("", "IADD3 R2, R2, 0x1, RZ"), ("@!P0", "BRA @c"), ("", "EXIT")]
    ins = roofline.sass_functions(listing("_ZN6bitpal13bitpal_kernelIELi32ELi0EEEv", body))
    ins = roofline.find_function(ins, "ELi32ELi0EE")
    per = roofline.column_instructions(ins, roofline.SASS_SPECS["bitpal"], inner_trips=16)
    # outer: LDS, LOP3, IADD3, BRA = 4 issued, 2 ALU; inner x 16: 5 issued,
    # 1 ALU (SHF), 1 FMA
    assert per == {"issue": 4 + 16 * 5, "alu": 2 + 16, "fma": 16}
    with pytest.raises(ValueError, match="nested loops"):
        roofline.column_instructions(ins, roofline.SASS_SPECS["bitpal"])


def test_sass_peak_kernel_step_from_its_main_loop():
    step = [("", "IMAD.IADD R4, R4, 0x1, R2"), ("", "SHF.R.U32.HI R5, RZ, 0x1, R4"),
            ("", "LOP3.LUT R4, R4, R5, R2, 0x1e, !PT"), ("", "IMAD.SHL.U32 R5, R4, 0x2, RZ"),
            ("", "LOP3.LUT R4, R4, R5, RZ, 0x3f, !PT")]
    body = [("", "LDG.E R4, desc[UR4][R2.64]"), ("", "UIADD3 UR4, UR4, 0x10, URZ", "main")]
    body += step * roofline.PEAK_UNROLL + [("@!P0", "BRA @main")]
    body += [("", "UIADD3 UR4, UR4, 0x1, URZ", "rest")] + step + [("@!P0", "BRA @rest")]
    body += [("", "STG.E desc[UR4][R2.64], R4"), ("", "EXIT")]
    ins = roofline.sass_functions(listing("_ZN4anon15int_peak_kernelILi1EEEv", body))
    per = roofline.column_instructions(
        roofline.find_function(ins, "int_peak_kernelILi1E"), roofline.SASS_SPECS["int_peak"])
    assert per == {"issue": 5 + 2 / 16, "alu": 3, "fma": 2}


def test_pipes_of_opcodes():
    assert roofline.pipe("LOP3.LUT") == ("issue", "alu")
    assert roofline.pipe("IMAD.WIDE.U32") == ("issue", "fma")
    assert roofline.pipe("ISETP.GT.U32.AND") == ("issue", "alu")
    for op in ("LDG.E.CONSTANT", "BRA", "UIADD3", "VIADD", "POPC"):
        assert roofline.pipe(op) == ("issue",)


def test_instruction_bound_picks_the_slowest_pipe():
    # 273 ALU, 162 FMA, 474 issued a column (myers_regs<16> on the H100):
    # ALU 273 / 64 > issue 474 / 128 > FMA 162 / 64
    per = {"alu": 273, "fma": 162, "issue": 474}
    instructions, rate, pipe = roofline.instruction_bound(per, 655_360_000, 132, 1980.0)
    assert pipe == "alu" and instructions == 273 * 655_360_000
    assert rate == pytest.approx(64 * 132 * 1.98e9)
    ms, by = roofline.bound(instructions, 10.5e6, rate)
    assert by == "operations" and ms == pytest.approx(273 * 655_360_000 / (64 * 132 * 1.98e9) * 1e3)
    per = {"alu": 41, "fma": 23, "issue": 88.5}  # a banded column: issue binds
    assert roofline.instruction_bound(per, 1, 132, 1980.0)[2] == "issue"
