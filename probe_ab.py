"""A/B of two checkouts on one GPU: the kernels whose launch bounds changed.

    python3 probe_ab.py OTHER_CHECKOUT

Run from the root of this checkout on a machine with a CUDA GPU;
OTHER_CHECKOUT is another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. The two trees run in turns, other / this / this /
other, each turn a child process started in its tree, so each builds and
imports its own ``bgsa_tpu_torch``. A turn prints:

- the registers and stack of every ``global31_regs`` and
  ``banded_packed_kernel`` instance in the tree's main kernel library, from
  ``cuobjdump -res-usage`` (it reads the library itself, so a cached one
  too);
- that tree's ``chip_smoke.py`` phase 14: the 31-bit and full-word Myers
  kernels timed by CUDA events on the same subjects at the bench geometry
  and at one production bucket;
- the packed banded kernel timed by CUDA events (median of 20 after 3
  warm-ups) on the filter mix (``chip_smoke.banded_inputs``) at the banded
  bench line and at one production bucket, at 150 bp queries and k = 8
  against 158 bp subjects (two fields a register) and 150 bp ones (three).

Exits with the first failing turn's code.
"""

import os
import subprocess
import sys

TURN = r"""
import os, re, statistics, subprocess, sys
import numpy as np
import torch
from torch.utils.cpp_extension import CUDA_HOME
sys.path.insert(0, ".")
import chip_smoke
from bgsa_tpu_torch.banded_pipeline import BandedEngine
from bgsa_tpu_torch.ops import banded_packed as bpk
from bgsa_tpu_torch.ops import build
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()
usage = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-res-usage",
                        build.load().path], capture_output=True, text=True, check=True).stdout
print(f"{sys.argv[1]}: cuobjdump -res-usage of {os.path.basename(build.load().path)}")
for name, res in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", usage):
    if "global31_regs" in name or "banded_packed_kernel" in name:
        print(f"  {name}: {res.strip()}")
rng = np.random.default_rng(2026)
chip_smoke.phase_myers_global_bench(rng, smi)
m, k = 150, 8
engine = BandedEngine(k, device="cuda")
for label, Q, S in chip_smoke.BANDED_TIMED:
    for n in (158, 150):
        q, s = chip_smoke.banded_inputs(rng, Q, m, S, n, k, "mix")
        codes, qt = torch.from_numpy(s).cuda(), torch.from_numpy(q).cuda()
        args = engine.kernel_args("banded_stream_packed", codes, m)
        kw = dict(q_len=m, s_len=n, k=k)
        ms = statistics.median(chip_smoke.cuda_times_ms(
            lambda: bpk.banded_stream_packed(*args, qt, **kw), runs=20, warmup=3))
        print(f"  packed banded, {label}: Q={Q} S={S} m={m} n={n} k={k} "
              f"n_sub={bpk.packed_subbands(m, n, k)}: kernel median {ms:.4f} ms over 20 runs "
              f"({smi})")
"""


def main(argv) -> int:
    if len(argv) != 1 or not os.path.isfile(os.path.join(argv[0], "chip_smoke.py")):
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(argv[0])
    rc = 0
    for label, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        print(f"== {label}: {tree}", flush=True)
        code = subprocess.run([sys.executable, "-c", TURN, label], cwd=tree).returncode
        rc = rc or code
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
