"""On-chip parity check: every kernel family of the port against the oracles.

The twin of ``scripts/tpu_parity.py``. The CPU suite holds each kernel's
plain version against ``bgsa_tpu``; this script runs the CUDA kernels on the
card and compares their scores with the port's numpy references
(``oracle``, ``banded_ref``) byte for byte, at the same deliberately
unaligned shapes: Q = 4, m = 137, S = 512, n = 211 with N codes for both
Myers kernels and both BitPAl kernels (both word layouts, both modes, and
the (1,-2,-3) and (5,-1,-2) networks); the banded stream, dual and
Peq-carry kernels at s > q, s = q and s < q; the packed banded kernel at
n_sub = 3, 6 and 5, the widths the CPU suite cannot run in JAX's interpret
mode.

    python -m bgsa_tpu_torch.scripts.gpu_parity [seed] [--device cpu]

It prints one ``ok``/``FAIL`` line a check and exits 1 on any mismatch, and
without a GPU unless ``--device cpu`` is given (the plain versions). One
check of ``tpu_parity.py`` maps to nothing (``SKIPPED``): its stream kernel
with ``block_exit=False``; the CUDA stream kernel has no such switch.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import banded_ref, oracle, pack
from ..benchutil import script_device
from ..ops import banded as bo
from ..ops import banded_packed as bpk
from ..ops import bitpal, bitpal_packed, myers_pallas, myers_semiglobal
from ..schemes import Mode, Scoring

# the checks' shapes (module level, so a test can shrink them)
Q, M, S, N = 4, 137, 512, 211
BANDED_M, BANDED_K, BANDED_S, BANDED_NEAR = 120, 9, 256, 80
PACKED = ((150, 150, 8), (100, 100, 4), (72, 72, 5))  # n_sub = 3, 6, 5
PACKED_LANES, PACKED_NEAR = 128, 40  # subjects per field, near copies of query 0
SKIPPED = {
    "banded stream {label} (no block exit)":
        "the JAX stream kernel's block_exit=False; the CUDA stream kernel has no such switch "
        "(its warps always leave once every lane is over budget)",
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m bgsa_tpu_torch.scripts.gpu_parity")
    p.add_argument("seed", nargs="?", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain torch versions)")
    args = p.parse_args(argv)
    device = script_device(args.device)
    if device is None:
        return 1
    rng = np.random.default_rng(args.seed)
    failures = []

    def check(name, got, want):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        want = np.asarray(want)
        ok = got.shape == want.shape and np.array_equal(got, want)
        print(f"{'ok ' if ok else 'FAIL'} {name}")
        if not ok:
            bad = np.argwhere(got != want)[:3] if got.shape == want.shape else []
            failures.append((name, [tuple(b) for b in bad]))

    def on_device(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(device)

    q = rng.integers(0, 4, size=(Q, M)).astype(np.int32)
    s = rng.integers(0, 5, size=(S, N))  # incl. N
    codes = on_device(s)
    eq31, eq32 = pack.pack_eq(codes, 31), pack.pack_eq(codes, 32)
    qd = on_device(q)

    unit = Scoring(0, -1, -1)
    want_g = np.stack([oracle.align_scores(qi, s, unit) for qi in q])
    want_sg = np.stack([oracle.align_scores(qi, s, unit, Mode.SEMI_GLOBAL) for qi in q])
    check("myers_pallas 31-bit global", myers_pallas.myers_global(eq31, qd, read_len=N), want_g)
    check("myers full-word global",
          myers_semiglobal.myers_semiglobal(eq32, qd, read_len=N, is_global=True, factor=-1),
          want_g)
    check("myers full-word semi-global",
          myers_semiglobal.myers_semiglobal(eq32, qd, read_len=N, factor=-1), want_sg)

    bp = Scoring(2, -3, -5)
    want_bp = np.stack([oracle.align_scores(qi, s, bp) for qi in q])
    want_bps = np.stack([oracle.align_scores_query_in_subject(qi, s, bp) for qi in q])
    kw = dict(match=2, mismatch=-3, gap=-5, read_len=N)
    for label, fn in (("packed", bitpal_packed.bitpal_packed), ("non-packed", bitpal.bitpal)):
        check(f"bitpal {label} global", fn(eq31, qd, **kw), want_bp)
        check(f"bitpal {label} semi", fn(eq31, qd, semi_global=True, **kw), want_bps)
        check(f"bitpal {label} 32-bit carry", fn(eq32, qd, word_bits=32, **kw), want_bp)
        check(f"bitpal {label} 32-bit carry semi",
              fn(eq32, qd, word_bits=32, semi_global=True, **kw), want_bps)
    # other networks: 3-plane packed, and a scheme only the non-packed kernel takes
    check("bitpal packed (1,-2,-3)",
          bitpal_packed.bitpal_packed(eq31, qd, match=1, mismatch=-2, gap=-3, read_len=N),
          np.stack([oracle.align_scores(qi, s, Scoring(1, -2, -3)) for qi in q]))
    check("bitpal non-packed (5,-1,-2)",
          bitpal.bitpal(eq31, qd, match=5, mismatch=-1, gap=-2, read_len=N),
          np.stack([oracle.align_scores(qi, s, Scoring(5, -1, -2)) for qi in q]))

    # banded: s > q and s = q (single stream), s < q (dual stream), Peq-carry
    mq, k = BANDED_M, BANDED_K
    qb = rng.integers(0, 4, size=(2, mq)).astype(np.int32)
    qbd = on_device(qb)
    bkw = dict(q_len=mq, k=k)
    for nb, label in ((mq + 10, "s>q"), (mq, "s==q"), (mq - 5, "s<q")):
        sb = rng.integers(0, 4, size=(BANDED_S, nb))
        sb[:BANDED_NEAR, :min(mq, nb)] = qb[0][:min(mq, nb)]
        want = np.stack([banded_ref.banded_scores(qi, sb, k) for qi in qb])
        cb = on_device(sb)
        if nb >= mq:
            got = bo.banded_stream(pack.pack_banded_stream(cb, k, mq), qbd, s_len=nb, **bkw)
        else:
            got = bo.banded_stream_dual(pack.pack_banded_streams(cb, k, mq), qbd, s_len=nb,
                                        **bkw)
        check(f"banded stream {label}", got, want)
        check(f"banded peq-carry {label}",
              bo.banded(*pack.pack_banded(cb, k, mq), qbd, s_len=nb, **bkw), want)

    # packed-field banded (subject-interleaved bands), n_sub = 3, 6, 5
    for mp, np_, kp in PACKED:
        n_sub = bpk.packed_subbands(mp, np_, kp)
        qp = rng.integers(0, 4, size=(2, mp)).astype(np.int32)
        sp = rng.integers(0, 4, size=(n_sub * PACKED_LANES, np_))
        sp[:PACKED_NEAR, :mp] = qp[0][:min(mp, np_)]
        streams = bpk.pack_packed_streams(on_device(sp), kp, mp, n_sub)
        check(f"banded packed n_sub={n_sub} (k={kp})",
              bpk.banded_stream_packed(streams, on_device(qp), q_len=mp, s_len=np_, k=kp),
              np.stack([banded_ref.banded_scores(qi, sp, kp) for qi in qp]))

    for name, why in SKIPPED.items():
        print(f"skip {name}: {why}")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (plain torch)"
    if failures:
        print(f"\nFAILURES ({where}): {failures}")
        return 1
    print(f"\nall kernels bit-exact vs the oracles ({where})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
