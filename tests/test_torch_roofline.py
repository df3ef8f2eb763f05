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
import sys

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


@pytest.mark.parametrize("bad", ["rank", "dtype", "rows", "unroll", "device"])
def test_int_peak_rejects_bad_inputs(bad):
    x = torch.ones((3, 16), dtype=torch.int32)
    kw = dict(steps=1, unroll=1)
    if bad == "device":
        x = x.to("meta")
    elif bad == "rank":
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
    """A column loop as a register instance with a runtime word count
    compiles it (global31_regs<MAXW>): the query code from shared memory,
    then MAXW guarded word copies, each loading its Eq word from global
    memory."""
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


def tile_kernel(w):
    """myers_regs<W> as it reads Eq from its block's shared-memory tile: the
    tile's staging loop (global loads, shared stores), then per query the
    warp's row staging loop and the column loop: the code from the row, its
    plane picked once (the zero plane past 4), then W words each an LDS at
    an immediate offset from that plane (no global load, no 64-bit address,
    no mask, no bound test) and the network's ALU ops."""
    body = [("", "S2R R0, SR_TID.X"),
            ("", "LDG.E.CONSTANT R6, desc[UR10][R4.64]", "tile"), ("", "STS [R7], R6"),
            ("", "IADD3 R7, R7, 0x200, RZ"), ("@P0", "BRA @tile"),
            ("", "BAR.SYNC.DEFER_BLOCKING 0x0"),
            ("", "LDG.E.U8.CONSTANT R8, desc[UR10][R2.64]", "query"), ("", "STS.U8 [R9], R8"),
            ("", "IADD3 R9, R9, 0x20, RZ"), ("@P1", "BRA @query"), ("", "WARPSYNC.ALL"),
            ("", "LDS.U8 R10, [R11+UR4]", "column"), ("", "IMNMX.U32 R10, R10, 0x5, PT"),
            ("", f"IMAD R12, R10, {w * 0x80:#x}, R13")]
    for j in range(w):
        body += [("", f"LDS R14, [R12+{j * 0x80:#x}]"),
                 ("", "LOP3.LUT R15, R14, R16, R17, 0xfe, !PT"),
                 ("", "IADD3 R18, R15, R16, RZ"), ("", "SHF.R.U32.HI R17, RZ, 0x1f, R18")]
    body += [("", "IADD3 R19, R19, R20, -R21"), ("@P2", "BRA @column"),
             ("", "STG.E desc[UR10][R22.64], R19"), ("@P3", "BRA @query"), ("", "EXIT")]
    return body


@pytest.mark.parametrize("w", [1, 5, 30])
def test_sass_tile_kernel_counts_its_column_loop_per_word_column(w):
    name = f"_ZN4anon10myers_regsILi{w}EEEvPKjPKhPiiiiiiii"
    functions = roofline.sass_functions(listing(name, tile_kernel(w)))
    ins = roofline.find_function(functions, roofline.SASS_SPECS["myers_semiglobal"].function
                                 .format(W=w))
    loop = ins[[x[2] for x in ins].index("LDS.U8"):[x[1] for x in ins].index("@P2") + 1]
    assert not any(x[2].startswith(("LDG", "IMAD.WIDE", "ISETP")) for x in loop)
    per = roofline.column_instructions(ins, roofline.SASS_SPECS["myers_semiglobal"])
    # a column: LDS.U8, IMNMX, IMAD, W x (LDS, LOP3, IADD3, SHF), IADD3,
    # back edge; per word-column 4 issued and 3 ALU, plus the column's own
    assert per == {"issue": 4 * w + 5, "alu": 3 * w + 2, "fma": 1}
    assert {p: v / w for p, v in per.items()} == {
        "issue": 4 + 5 / w, "alu": 3 + 2 / w, "fma": 1 / w}


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
    # the per-column form's two byte loads a column (the query code and the
    # checkpoint flag), as the stream, Peq-carry and paired-query kernels
    # read them before their window fold
    name = "_ZN4anon20banded_stream_kernelILb0EEEv"
    ins = roofline.sass_functions(listing(name, banded_kernel()))[name]
    spec = roofline.SassSpec("banded_stream_kernelILb0E", "LDG.E.U8.CONSTANT", 2, every=False)
    per = roofline.column_instructions(ins, spec)
    # head: 12 instructions; the code check falls through, @P3 skips two LOP3s
    # -> 10 issued, 2 ALU (ISETP, SHF), 1 FMA; batch: 16 a trip over 2
    # columns -> 8 issued, ALU (2 ISETP, 2 LOP3, 2 IADD3) / 2 = 3, FMA 1 / 2;
    # each pipe takes the cheaper loop
    assert per == {"issue": 8, "alu": 2, "fma": 0.5}
    every = roofline.SassSpec("banded_stream_kernelILb0E", "LDG.E.U8.CONSTANT", 2, every=True)
    # every branch falling through: the head loop's 12, the batch loop's 8
    assert roofline.column_instructions(ins, every) == {"issue": 8, "alu": 3, "fma": 0.5}


def window_fold_kernel(whole=True, chains=1):
    """The stream kernels' batch loops as the window fold compiles them:
    each batch loads the window into the slot (10 loads, 5 stores), then a
    generic batch runs a column loop (the code from the staged row, the
    slot's words, the funnel shift, the band update; 7 instructions a trip
    here) and a whole batch (``whole``) 32 unrolled columns (4 instructions
    each: the funnel amount is a constant); each batch ends with the latch
    and the warp's vote. ``chains`` 2: the pair kernel, whose column reads
    both rows' codes and folds the slot once for each."""
    window = [("", f"LDG.E.CONSTANT R{20 + c}, desc[UR6][R8.64+{4 * c:#x}]") for c in range(10)]
    window += [("", f"STS.64 [R3+{0x400 * c:#x}], R{20 + 2 * c}") for c in range(5)]
    vote = [("", "ISETP.GT.AND P4, PT, R2, UR8, PT"), ("", "VOTE.ALL P5, P4")]
    body = [("", "S2R R0, SR_TID.X")]
    body += [(*window[0], "generic")] + window[1:]
    column = [("", "LDS.U8 R12, [R4+UR5]"), ("", "LEA R13, R12, R3, 0xa"),
              ("", "LDS.64 R14, [R13]"), ("", "SHF.R.W.U32 R16, R14, R7, R15"),
              ("", "LOP3.LUT R17, R16, R10, RZ, 0xfc, !PT")] * chains
    body += [(*column[0], "col")] + column[1:]
    body += [("", "VIADD R4, R4, 0x1"), ("@!P3", "BRA @col")]
    body += vote + [("@!P5", "BRA @generic")]
    if whole:
        body += [(*window[0], "whole")] + window[1:]
        for i in range(32):
            body += [("", f"LDS.U8 R12, [R4+{i:#x}]"), ("", "LEA R13, R12, R3, 0xa"),
                     ("", "LDS.64 R14, [R13]"), ("", f"SHF.R.W.U32 R16, R14, {i:#x}, R15")
                     ] * chains
        body += vote + [("@!P5", "BRA @whole")]
    return body + [("", "EXIT")]


def test_sass_stream_kernel_counts_its_column_loops_not_the_window_load():
    spec = roofline.SASS_SPECS["banded_stream"]
    assert (spec.anchor, spec.anchors) == ("LDS.U8", 1)
    name = "_ZN4anon20banded_stream_kernelILb0ELb0EEEvPKjPKhPiiiiiiiiii"
    generic = roofline.sass_functions(listing(name, window_fold_kernel(whole=False)))
    per = roofline.column_instructions(
        roofline.find_function(generic, spec.function.format(wide=0)), spec)
    # the generic column loop: LDS.U8, LEA, LDS.64, SHF, LOP3, VIADD, BRA
    # (ALU: LEA, SHF, LOP3); the window's 10 loads and 5 stores lie outside it
    assert per == {"issue": 7, "alu": 3, "fma": 0}
    functions = roofline.sass_functions(listing(name, window_fold_kernel()))
    per = roofline.column_instructions(
        roofline.find_function(functions, spec.function.format(wide=0)), spec)
    # the whole batches: 32 x 4 + 15 (the window, once a batch) + 3 (the
    # vote, the back edge) issued over 32 columns (ALU: 32 x (LEA, SHF) +
    # ISETP), cheaper than the generic loop on every pipe
    assert per == {"issue": (128 + 15 + 3) / 32, "alu": (64 + 1) / 32, "fma": 0}
    with pytest.raises(ValueError, match="0 SASS functions"):
        roofline.find_function(functions, roofline.SASS_SPECS["banded_stream_dual"].function
                               .format(wide=0))
    # the instances' template arguments are csrc/banded.cu's <Dual, Wide>
    with open(os.path.join(REPO, "bgsa_tpu_torch", "csrc", "banded.cu")) as f:
        text = f.read()
    assert "template <bool Dual, bool Wide>\n__global__" in text
    assert "const bool wide = band_down >= 32;" in text


def peq_window_kernel():
    """The Peq-carry kernel's batch loop as the window fold compiles it: at
    the batch's top the injection words (4 loads a code), B's words (a
    funnel shift and a mask each) and the initial window's slot (2 loads
    a code), each stored into its slot; then the head's column loop (the
    code from the staged row, both slots' words, four funnel shifts, the
    mask and the OR; 11 instructions a trip here) and the B-only column
    loop (7), each batch ending with the latch and the warp's vote."""
    top = [("", f"LDG.E.CONSTANT R{20 + i}, desc[UR6][R8.64+{4 * i:#x}]") for i in range(20)]
    top += [("", f"SHF.R.W.U32 R{40 + i}, R{20 + i}, R7, R{21 + i}") for i in range(10)]
    top += [("", f"LOP3.LUT R{40 + i}, R{40 + i}, R6, RZ, 0xc0, !PT") for i in range(10)]
    top += [("", f"STS.64 [R3+{0x400 * c:#x}], R{40 + 2 * c}") for c in range(5)]
    top += [("", f"LDG.E.CONSTANT R{50 + i}, desc[UR6][R9.64+{4 * i:#x}]") for i in range(10)]
    top += [("", f"STS.128 [R5+{0x800 * c:#x}], R{48 + 2 * c}") for c in range(5)]
    vote = [("", "ISETP.GT.AND P4, PT, R2, UR8, PT"), ("", "VOTE.ALL P5, P4")]
    body = [("", "S2R R0, SR_TID.X"), (*top[0], "batch")] + top[1:]
    body += [("", "LDS.U8 R12, [R4+UR5]", "head"), ("", "LEA R13, R12, R3, 0xa"),
             ("", "LDS.64 R14, [R13]"), ("", "LDS.128 R16, [R13+0x3000]"),
             ("", "SHF.R.W.U32 R20, R14, R7, R15"), ("", "SHF.R.W.U32 R21, R16, R7, R17"),
             ("", "SHF.R.W.U32 R22, R17, R7, R18"), ("", "LOP3.LUT R20, R20, R10, RZ, 0xc0, !PT"),
             ("", "LOP3.LUT R20, R20, R21, RZ, 0xfc, !PT"), ("", "VIADD R4, R4, 0x1"),
             ("@!P3", "BRA @head")]
    body += [("", "LDS.U8 R12, [R4+UR5]", "col"), ("", "LEA R13, R12, R3, 0xa"),
             ("", "LDS.64 R14, [R13]"), ("", "SHF.R.W.U32 R16, R14, R7, R15"),
             ("", "LOP3.LUT R17, R16, R10, RZ, 0xfc, !PT"), ("", "VIADD R4, R4, 0x1"),
             ("@!P2", "BRA @col")]
    return body + vote + [("@!P5", "BRA @batch"), ("", "EXIT")]


def test_sass_peq_kernel_counts_its_column_loops_not_the_batch_top():
    # the Peq-carry kernel reads its query code from the staged row, one
    # LDS.U8 a column (no checkpoint byte); the injection words, B's funnel
    # shifts and masks and the initial window's loads lie at the batch's
    # top, outside the column loops; the cheaper column loop (B alone) is
    # the bound's
    spec = roofline.SASS_SPECS["banded"]
    assert (spec.anchor, spec.anchors, spec.every) == ("LDS.U8", 1, False)
    name = "_ZN4anon17banded_peq_kernelILb0EEEvPKjS1_S1_PKhPiiiiiiiiii"
    other = "_ZN4anon17banded_peq_kernelILb1EEEvPKjS1_S1_PKhPiiiiiiiiii"
    functions = roofline.sass_functions(listing(name, peq_window_kernel())
                                        + listing(other, peq_window_kernel()))
    ins = roofline.find_function(functions, spec.function.format(wide=0))
    assert ins is functions[name]
    per = roofline.column_instructions(ins, spec)
    # LDS.U8, LEA, LDS.64, SHF, LOP3, VIADD, BRA (ALU: LEA, SHF, LOP3)
    assert per == {"issue": 7, "alu": 3, "fma": 0}
    # the template argument is csrc/banded.cu's <Wide>
    with open(os.path.join(REPO, "bgsa_tpu_torch", "csrc", "banded.cu")) as f:
        text = f.read()
    assert "template <bool Wide>\n__global__ void __launch_bounds__(kThreads, 1)\nbanded_peq_kernel(" \
        in text


def test_sass_nested_loop_counts_one_trip():
    # a loop inside the column loop (the packed banded kernel's window load)
    # counts one trip where the path runs through it, and none where a branch
    # the shortest path takes skips it: a floor either way
    body = [("", "LDS.U8 R122, [R40+UR4]", "c"), ("", "LOP3.LUT R1, R2, R3, RZ, 0xc0, !PT"),
            ("", "LDG.E R5, desc[UR4][R6.64]", "w"), ("", "IMAD R5, R5, 0x2, RZ"),
            ("", "SHF.L.U32 R5, R5, 0x1, RZ"), ("", "STG.E desc[UR4][R6.64], R5"),
            ("@!P1", "BRA @w"), ("", "IADD3 R2, R2, 0x1, RZ"), ("@!P0", "BRA @c"), ("", "EXIT")]
    ins = roofline.sass_functions(listing("_ZN6bitpal13bitpal_kernelIELi32ELi0EEEv", body))
    ins = roofline.find_function(ins, "ELi32ELi0EE")
    per = roofline.column_instructions(ins, roofline.SASS_SPECS["bitpal"])
    # LDS, LOP3, one trip of LDG, IMAD, SHF, STG, BRA, then IADD3, BRA
    assert per == {"issue": 9, "alu": 3, "fma": 1}
    skip = body[:2] + [("@P2", "BRA @s")] + body[2:7] + [(*body[7][:2], "s")] + body[8:]
    ins = roofline.sass_functions(listing("_ZN4anon20banded_packed_kernelILi3EEEv", skip))
    per = roofline.column_instructions(
        roofline.find_function(ins, "banded_packed_kernelILi3E"),
        roofline.SASS_SPECS["banded_stream_packed"])
    # the shortest path takes @P2 over the loop: LDS, LOP3, BRA, IADD3, BRA
    assert per == {"issue": 5, "alu": 2, "fma": 0}


def test_sass_without_a_loop_that_loads_the_anchor_raises():
    body = [("", "LOP3.LUT R1, R2, R3, RZ, 0xc0, !PT", "c"), ("", "IADD3 R2, R2, 0x1, RZ"),
            ("@!P0", "BRA @c"), ("", "EXIT")]
    ins = roofline.sass_functions(listing("_ZN6bitpal13bitpal_kernelIELi32ELi0EEEv", body))
    with pytest.raises(ValueError, match="no loop loads"):
        roofline.column_instructions(roofline.find_function(ins, "ELi32ELi0EE"),
                                     roofline.SASS_SPECS["bitpal"])


def test_io_bytes_and_no_cuobjdump(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    assert roofline.io_bytes(torch.zeros(3, 4, dtype=torch.int32),
                             torch.zeros(5, dtype=torch.int8)) == 53
    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path))  # a toolkit without cuobjdump
    assert roofline.sass_text("lib.so") is None


def test_sass_tiled_kernel_counts_one_word_column():
    # bitpal_tiled_kernel: a word loop (planes loaded and stored) around the
    # column loop (the code from shared memory, the carry slot loaded and
    # stored, the network); one trip of the inner loop is one word-column
    body = [("", "LDG.E R20, desc[UR4][R6.64]", "w"), ("", "LOP3.LUT R9, R20, R8, RZ, 0xc0, !PT")]
    body += [("", "LDS.U8 R12, [R3+UR4]", "c"), ("", "LDS R13, [R5]"),
             ("", "LDG.E.CONSTANT R14, desc[UR4][R10.64]"),
             ("", "LOP3.LUT R15, R13, 0x1, RZ, 0xc0, !PT"), ("", "IADD3 R16, R14, R15, R20"),
             ("", "IMAD.SHL.U32 R17, R16, 0x2, RZ"), ("", "STS [R5], R17"),
             ("", "VIADD R3, R3, 0x1"), ("@!P0", "BRA @c")]
    body += [("", "STG.E desc[UR4][R6.64], R20"), ("@!P1", "BRA @w"), ("", "EXIT")]
    name = ("_ZN6bitpal19bitpal_tiled_kernelINS_12_GLOBAL__N_18UnpackedILi2ELin3ELin5ELi32EEE"
            "Li32EEEvPKjPKhPiPjiiiiiiii")
    other = "_ZN6bitpal13bitpal_kernelINS_8UnpackedILi2ELin3ELin5ELi32EEELi32ELi32EEEvPKj"
    functions = roofline.sass_functions(listing(name, body) + listing(other, word_kernel(1)))
    spec = roofline.SASS_SPECS["bitpal_tiled"]
    ins = roofline.find_function(functions, spec.function.format(bits=32))
    assert ins is functions[name]  # the regular expression skips the register instance
    with pytest.raises(ValueError, match="0 SASS functions"):
        roofline.find_function(functions, spec.function.format(bits=31))
    per = roofline.column_instructions(ins, spec)
    # LDS.U8, LDS, LDG, LOP3, IADD3, IMAD, STS, VIADD, BRA
    assert per == {"issue": 9, "alu": 2, "fma": 1}


def strip_kernel(words, code):
    """The Myers strip kernels' loops as they compile: a batch loop (the
    carry words of 32 columns loaded, and in the wavefront a lane's query
    code; the carries stored; the wavefront's barrier) around the column
    loop (the code, ``code``: from the staged row or shuffled from its lane;
    the carry bits out of the words, ``words`` guarded word copies of 3
    instructions, the bits packed back)."""
    body = [("", "S2R R0, SR_TID.X"), ("", "LDG.E R40, desc[UR4][R8.64]", "batch"),
            ("", "LDG.E R41, desc[UR4][R10.64]"), ("", "LDG.E.U8 R44, desc[UR4][R12.64]"),
            ("", code, "col"),
            ("", "SHF.R.U32.HI R42, RZ, R7, R40"), ("", "LOP3.LUT R42, R42, 0x1, RZ, 0xc0, !PT")]
    for j in range(words):
        body += [("", f"ISETP.GE.AND P0, PT, R46, {j + 1:#x}, PT"), ("@!P0", f"BRA @g{j}"),
                 ("", "LDG.E.CONSTANT R28, desc[UR10][R28.64]"),
                 ("", "LOP3.LUT R31, R47, R20, RZ, 0xc0, !PT"),
                 ("", "IMAD.SHL.U32 R48, R31, 0x2, RZ", f"g{j}")]
    body += [("", "SHF.L.U32 R43, R42, R7, RZ"), ("", "LOP3.LUT R44, R44, R43, RZ, 0xfc, !PT"),
             ("", "VIADD R7, R7, 0x1"), ("@!P1", "BRA @col"),
             ("", "STG.E desc[UR4][R8.64], R44"), ("", "BAR.SYNC.DEFER_BLOCKING 0x0"),
             ("@!P2", "BRA @batch"), ("", "EXIT")]
    return body


@pytest.mark.parametrize("name,kernel,other,code", [
    ("myers_semiglobal_strips", "myers_strips", "myers_strips_wave", "LDS.U8 R45, [R3+UR9]"),
    ("myers_global_strips", "global31_strips", "global31_strips_wave", "LDS.U8 R45, [R3+UR9]"),
    ("myers_semiglobal_wave", "myers_strips_wave", "myers_strips",
     "SHFL.IDX PT, R45, R44, R7, 0x1f"),
    ("myers_global_wave", "global31_strips_wave", "global31_strips",
     "SHFL.IDX PT, R45, R44, R7, 0x1f")])
def test_sass_strip_kernel_counts_one_word_column(name, kernel, other, code):
    # the strip kernel's column loop holds one column of 32 words: its
    # count, per word-column, is the design's; neither the register
    # instance beside it (the bound's) nor the other schedule of the strips
    # is the one the pattern finds
    spec = roofline.SASS_SPECS[name]
    assert (spec.anchor, spec.words) == (code.split()[0], 32)
    strips = f"_ZN4anon{len(kernel)}{kernel}EPKjPKhPiPjiiiiiii"
    regs = "_ZN4anon10myers_regsILi32EEEvPKjPKhPiiiiiiii"
    functions = roofline.sass_functions(
        listing(strips, strip_kernel(32, code)) + listing(regs, word_kernel(32))
        + listing(f"_ZN4anon{len(other)}{other}EPKjPKhPiPjiiiiiii", strip_kernel(32, code)))
    ins = roofline.find_function(functions, spec.function)
    assert ins is functions[strips]
    per = roofline.column_instructions(ins, spec)
    # the code, SHF, LOP3, 32 x (ISETP, BRA, LDG, LOP3, IMAD), SHF, LOP3,
    # VIADD, BRA: 167 issued (ALU: SHF, LOP3, 32 x (ISETP, LOP3), SHF, LOP3;
    # FMA: 32 IMAD) over 32 word-columns; the batch loop's loads, stores and
    # barrier lie outside the column loop
    assert per == {"issue": 167 / 32, "alu": 68 / 32, "fma": 1}
    bound = roofline.column_instructions(
        roofline.find_function(functions, roofline.SASS_SPECS["myers_semiglobal"].function
                               .format(W=32)), roofline.SASS_SPECS["myers_semiglobal"])
    # the register network's own column: LDS, 32 x 5, IADD3, back edge
    assert bound == {"issue": 163, "alu": 65, "fma": 32}


@pytest.mark.parametrize("name,kernel", [("myers_semiglobal_wave", "myers_strips_wave"),
                                         ("myers_global_wave", "global31_strips_wave")])
def test_sass_wavefront_counts_its_column_loop_past_the_shuffles_slow_path(name, kernel):
    # the shuffle compiles to BRA.DIV (taken only on a diverged warp) before
    # the SHFL, and its slow path lies past the kernel's end, jumping back
    # into the column loop: the branch falls through, the jump back is no
    # loop of its own
    code = "SHFL.IDX PT, R45, R44, R7, 0x1f"
    body = strip_kernel(32, code)
    col = body.index(("", code, "col"))
    body[col:col + 2] = [("", "BRA.DIV UR13, @slow", "col"), ("", code),
                         (*body[col + 1], "back")]
    body += [("", "BSSY B1, @join", "slow"), ("", "WARPSYNC.COLLECTIVE R85, @join"),
             ("", "SHFL.IDX P1, R45, R44, R88, R90"), ("", "ENDCOLLECTIVE"),
             ("", "BSYNC B1", "join"), ("", "BRA @back")]
    ins = roofline.sass_functions(listing(f"_ZN4anon{len(kernel)}{kernel}EPKjPKhPiPjiiiiiii",
                                          body))
    per = roofline.column_instructions(ins[next(iter(ins))], roofline.SASS_SPECS[name])
    # the strip kernel's 167 issued and the BRA.DIV
    assert per == {"issue": 168 / 32, "alu": 68 / 32, "fma": 1}


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


def test_sass_probe_kernel_column_from_its_innermost_largest_loop():
    # a probe that loads no query code: the query loop holds a 16-column main
    # loop and a one-column remainder; the column is the main loop's trip / 16
    col = [("", "LOP3.LUT R4, R4, R5, RZ, 0xfe, !PT"), ("", "IADD3 R6, P0, R4, R6, RZ"),
           ("", "IMAD.X R7, R5, 0x1, R7, P0")]
    body = [("", "S2R R0, SR_TID.X"), ("", "MOV R9, RZ", "q")]
    body += [("", "UIADD3 UR4, UR4, 0x10, URZ", "main")] + col * roofline.PEAK_UNROLL
    body += [("@!P1", "BRA @main")]
    body += [("", "UIADD3 UR4, UR4, 0x1, URZ", "rest")] + col + [("@!P2", "BRA @rest")]
    body += [("", "STG.E desc[UR4][R2.64], R4"), ("@!P3", "BRA @q"), ("", "EXIT")]
    name = "_ZN4anon19banded_probe_kernelILi2EEEvPKj"
    ins = roofline.sass_functions(listing(name, body))[name]
    per = roofline.column_instructions(ins, roofline.SASS_SPECS["banded_probe_noload"])
    # 16 x 3 + UIADD3 + BRA over 16 columns: 2 ALU (LOP3, IADD3), 1 FMA
    assert per == {"issue": 3 + 2 / 16, "alu": 2, "fma": 1}


def test_sass_specs_of_the_paired_query_kernels():
    specs = roofline.SASS_SPECS
    # both query codes from the rows staged in shared memory, two a pair
    # column, the window's loads outside the cheapest path (as the shipping
    # stream and packed kernels)
    for name in ("banded_stream_pair", "banded_packed_pair"):
        assert (specs[name].anchor, specs[name].anchors, specs[name].every) == (
            "LDS.U8", 2, False), name
    assert specs["banded_stream_pair"].function.format(wide=1) == (
        "banded_stream_pair_kernelILb1E")
    assert specs["banded_packed_pair"].function.format(n_sub=3) == (
        "banded_packed_pair_kernelILi3E")
    assert specs["banded_probe_full"].anchors == 1
    for mode, i in (("full", 0), ("static_c", 1), ("noload", 2)):
        assert specs[f"banded_probe_{mode}"].function == f"banded_probe_kernelILi{i}E"
    assert specs["banded_probe_static_c"].anchor is specs["banded_probe_noload"].anchor is None
    # the probe's template argument order and its pinned trip are csrc/banded_pair.cu's
    with open(os.path.join(REPO, "bgsa_tpu_torch", "csrc", "banded_pair.cu")) as f:
        text = f.read()
    assert "kProbeFull = 0, kProbeStaticC = 1, kProbeNoLoad = 2" in text
    assert f"kProbeUnroll = {roofline.PEAK_UNROLL};" in text
    # the stream pair's instance is csrc/banded_pair.cu's <Wide>, chosen as
    # the stream kernel chooses it
    assert "template <bool Wide>\n__global__ void __launch_bounds__(kThreads, 1)\n" \
           "banded_stream_pair_kernel(" in text
    assert "return band_down >= 32\n             ? launch_pair<true>" in text


def test_sass_stream_pair_kernel_counts_pair_columns():
    # one trip of the pair's column loops holds both chains' columns: two
    # LDS.U8 a pair column, so a pair column costs two chains' instructions
    spec = roofline.SASS_SPECS["banded_stream_pair"]
    name = "_ZN4anon25banded_stream_pair_kernelILb0EEEvPKjPKhPiiiiiiiiii"
    generic = roofline.sass_functions(listing(name, window_fold_kernel(whole=False, chains=2)))
    per = roofline.column_instructions(
        roofline.find_function(generic, spec.function.format(wide=0)), spec)
    # 2 x (LDS.U8, LEA, LDS.64, SHF, LOP3) + VIADD + BRA (ALU: 2 x (LEA, SHF, LOP3))
    assert per == {"issue": 12, "alu": 6, "fma": 0}
    functions = roofline.sass_functions(listing(name, window_fold_kernel(chains=2)))
    per = roofline.column_instructions(
        roofline.find_function(functions, spec.function.format(wide=0)), spec)
    # the whole batches: 32 x 8 + 15 (the window, once a batch for both
    # chains) + 3 issued over 32 pair columns (ALU: 32 x 2 x (LEA, SHF) + ISETP)
    assert per == {"issue": (256 + 15 + 3) / 32, "alu": (128 + 1) / 32, "fma": 0}


def load_chip_smoke():
    if "chip_smoke" in sys.modules:
        return sys.modules["chip_smoke"]
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod  # its dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("launch_ms, nbytes, by", [
    (0.0011, None, "launch"),  # the kprint row: an empty launch outlasts its 8 KB
    (0.0, None, "bytes"),  # no launch floor measured
    (0.0011, 3.35e7, "bytes"),  # bytes that outlast the launch
])
def test_kernel_bound_of_a_row_that_computes_nothing(launch_ms, nbytes, by):
    smoke = load_chip_smoke()
    nbytes = smoke.KPRINT_BYTES if nbytes is None else nbytes
    work = smoke.Work(None, {}, 0, nbytes, None, launch_ms=launch_ms)
    bound_ms, bound_by, pipe, per_column, share = smoke.kernel_bound(
        "kprint_probe", 0.05, work, {}, None)
    assert bound_by == by
    assert bound_ms == pytest.approx(max(nbytes / roofline.MEMORY_BYTES_PER_S * 1e3, launch_ms))
    assert (pipe, per_column, share) == (None, None, None)
    # the kernels line's bound_by keeps its two words
    assert smoke.LINE_BOUND_BY[bound_by] == ("bytes" if by == "bytes" else "operations")
