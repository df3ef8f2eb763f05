"""The least time the card could take for each kernel's work: every
kernel's own instructions (its SASS) at each pipe's published rate, and the
int32 issue-peak microbenchmark that shows those rates hold on the card.

Counterpart of ``scripts/roofline.py``. Its peak kernel (``_peak_kernel``)
becomes ``csrc/int_peak.cu`` with ``int_peak_ref`` beside it, and its
operation counts become constants, because the port cannot import jax.

* The bound (``column_instructions``, ``instruction_bound``, ``bound``):
  ``cuobjdump -sass`` of the built library gives the instructions of the
  kernel instance that ran; the column loop is the innermost loop that loads
  the query code (``SassSpec.anchor``), or in a kernel that loads none the
  largest innermost loop, pinned at PEAK_UNROLL columns a trip, and one
  column costs the instructions of one trip through it over the columns
  that trip holds. A trip counts every instruction where every branch in
  the loop falls through on the timed inputs (the word kernels at W equal
  to the instance's word count: the per-word guards), and otherwise the
  shortest path through the loop with only the query-code checks falling
  through (the banded kernels on inputs without N). Each count goes to the
  pipes it occupies (``pipe``):
  the integer ALU pipe and the FMA pipe (IMAD) each retire 64 int32 results
  per clock per SM, and the SM issues 4 warp-instructions (128 thread
  instructions) per clock (CUDA C++ Programming Guide, arithmetic instruction
  throughput and the Hopper SM, compute capability 9.0). The instruction
  bound is the slowest pipe's time for the columns the inputs need at
  ``clocks.max.sm`` on every SM; ``bound`` takes the larger of it and the
  bytes moved (each input read once, each output written once) over the
  card's memory rate. For the banded kernels the columns needed are the live
  (lane, column) pairs: the columns each pair runs before the reference's
  checkpoints latch it over budget (``banded_ref``), counted by the plain
  versions (``ops.banded.banded_stream_ref(..., live=...)``); for a kernel
  whose thread carries several pairs (the paired-query kernels), the
  thread's columns, which run until all of its pairs are over budget
  (``threads=``). The banded probes have no early exit: every column of
  every pair.
* ``WORD_OPS``, ``BANDED_OPS``: elementwise ALU operations of each kernel's
  JAX column function, counted from its jaxpr the way
  ``scripts/roofline.py`` counts them (``count_alu``). For the word-parallel
  kernels a column over W words costs ``per_word * W + per_column``; for the
  banded kernels one column of one lane (one subject) costs a fixed count at
  the bench line's geometry (150 bp, k = 8), and one packed column serves
  ``n_sub`` lanes. The CPU tests recompute every constant from the JAX
  package. They are the work the JAX source writes down, not a floor: ptxas
  folds logic into LOP3 and moves adds and shifts to IMAD, so they only
  compare kernels against the peak kernel's source-op rate.

``int_peak`` runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, counting launches in ``LAUNCHES``;
``measure_int32_peak`` times it with CUDA events and reports how the time
scales when the iterations double, and ``derived_int32_peak`` is one pipe's
published figure, SMs x 64 int32 results per clock per SM x the SM clock.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
import subprocess

import torch

# ops of one chain iteration of the peak kernel: add, shr, xor, or, shl, and, not
PEAK_OPS_PER_CHAIN_ITER = 7
# steps (or columns) in one trip of the main loop of a kernel that loads no
# query code: csrc/int_peak.cu's kUnroll and csrc/banded_pair.cu's kProbeUnroll
PEAK_UNROLL = 16
INT32_PER_CLOCK_PER_SM = 64
MEMORY_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3 (NVIDIA's data sheet)

# (ops per word and column, ops per column) of the word-parallel kernels'
# JAX column functions; bits: useful bits per word of the layout counted.
WORD_OPS = {
    # bgsa_tpu/ops/myers_semiglobal.py::_column, full 32-bit words, global
    "myers_semiglobal": (20, 6, 32),
    # bgsa_tpu/ops/myers_pallas.py::_column_words, 31-bit words
    "myers_global": (23, 7, 31),
    # bgsa_tpu/ops/bitpal_packed.py::_packed_column, (2,-3,-5), 31-bit words
    "bitpal_packed": (172, -17, 31),
    # bgsa_tpu/ops/bitpal.py::_bitpal_column, (2,-3,-5), 32-bit words
    "bitpal": (329, 0, 32),
}
# ops of one banded column of one lane at q_len = s_len = 150, k = 8:
# bgsa_tpu/ops/banded.py::_stream_column, _stream2_column (the dual kernel's
# columns t <= 2k; the rest are _stream_column), _banded_column (Peq-carry),
# and banded_packed's column (funnel_window x n_sub + fold_window_fields +
# _packed_update), which serves PACKED_LANES lanes.
BANDED_OPS = {
    "banded_stream": 47,
    "banded_stream_dual": 52,
    "banded": 57,
    "banded_stream_packed": 67,
}
BANDED_GEOMETRY = (150, 150, 8)  # (q_len, s_len, k) of BANDED_OPS
PACKED_LANES = 3  # n_sub at BANDED_GEOMETRY

# Kernel launches made by ``int_peak`` (CUDA tensors only).
LAUNCHES = 0


def ops_per_cell(name: str, s_len: int) -> float:
    """JAX operations per DP cell of a word-parallel kernel at subject
    length ``s_len`` (a column covers s_len cells)."""
    per_word, per_column, bits = WORD_OPS[name]
    words = -(-s_len // bits)
    return (per_word * words + per_column) / s_len


def word_kernel_ops(name: str, Q: int, m: int, S: int, s_len: int) -> int:
    """JAX operations of a word-parallel kernel over Q x m query columns and
    S subjects of s_len bp: every column of every pair runs."""
    per_word, per_column, bits = WORD_OPS[name]
    return (per_word * -(-s_len // bits) + per_column) * Q * m * S


def banded_ops(name: str, live_per_column, k: int = BANDED_GEOMETRY[2]) -> float:
    """JAX operations of a banded kernel given the live lanes before each
    column (``live_per_column[t]``, summed over queries and subjects)."""
    if name == "banded_stream_dual":
        head = sum(live_per_column[:2 * k + 1])
        return BANDED_OPS[name] * head + BANDED_OPS["banded_stream"] * (
            sum(live_per_column) - head)
    if name == "banded_stream_packed":
        return BANDED_OPS[name] * sum(live_per_column) / PACKED_LANES
    return BANDED_OPS[name] * sum(live_per_column)


def io_bytes(*tensors) -> int:
    """Bytes of the tensors (inputs read once, outputs written once)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, nbytes: float, peak_ops_per_s: float) -> tuple[float, str]:
    """(bound ms, "operations" or "bytes"): the larger of ops / peak and
    bytes / memory rate, and which of the two it is."""
    ops_ms = ops / peak_ops_per_s * 1e3
    bytes_ms = nbytes / MEMORY_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# -- the instruction bound: each kernel's own SASS ------------------------------

# thread-instructions per clock per SM: the integer ALU pipe, the FMA pipe
# (IMAD and the float ops), and issue (4 schedulers x 1 warp-instruction)
PIPE_RATES = {"alu": 64, "fma": 64, "issue": 128}
FMA_PIPE = ("IMAD", "IMUL", "FFMA", "FMUL", "FADD")
# opcodes that certainly run on the ALU pipe; others (VIADD, VIMNMX, MOV,
# POPC, loads, branches, uniform-datapath U* ops) count toward issue only,
# which keeps the bound a floor
ALU_PIPE = ("LOP3", "SHF", "IADD3", "ISETP", "LEA", "SEL", "PLOP3", "PRMT", "IMNMX", "P2R",
            "R2P")
_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T\d]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);",
                   re.M)


@dataclasses.dataclass(frozen=True)
class SassSpec:
    """Where a kernel's column loop is in its SASS.

    function: a regular expression that finds the instance's mangled name,
      formatted with the shape (``W``, ``bits``, ``n_sub``, ``chains``,
      ``wide``);
    anchor: the opcode that loads a column's query code, ``anchors`` times a
      column (None: a kernel that loads none, whose largest innermost loop
      holds PEAK_UNROLL columns or chain steps: the peak kernel, and the
      banded probes that read no query code);
    every: every branch in the loop falls through on the timed inputs;
    words: word-columns one column of the loop holds (the Myers strip
      kernels: a strip of 32 words), so that counts are per word-column.
    """

    function: str
    anchor: str | None
    anchors: int = 1
    every: bool = True
    words: int = 1


_CODE = "LDG.E.U8.CONSTANT"
SASS_SPECS = {
    "myers_semiglobal": SassSpec("myers_regsILi{W}E", "LDS.U8"),
    "myers_global": SassSpec("global31_regsILi{W}E", "LDS.U8"),
    # the register instances: one column of all W words a trip
    "bitpal_packed": SassSpec("ELi{bits}ELi{W}EE", "LDS.U8"),
    "bitpal": SassSpec("ELi{bits}ELi{W}EE", "LDS.U8"),
    # the tiled kernel past the register bound: one word of one column a
    # trip (its column loop runs inside the word loop). Its bound is the
    # network's cost, the largest register instance's SASS per column over
    # its words; this count, with the tiled design's carry packing and slot
    # traffic, is reported beside the bound and never in it
    "bitpal_packed_tiled": SassSpec(r"bitpal_tiled_kernel.*ELi{bits}EEEv", "LDS.U8"),
    "bitpal_tiled": SassSpec(r"bitpal_tiled_kernel.*ELi{bits}EEEv", "LDS.U8"),
    # the Myers strip kernels past the register bound: one column of a strip
    # of 32 words a trip (the code from the staged row, or in the wavefront
    # shuffled from the lane that loaded it; the strip's words; the carry
    # bits in and out). Their bound is the network's cost, the <32>
    # register instance's SASS per column over its 32 words, for every
    # word-column; this count, per word-column, is reported beside the bound
    # and never in it
    "myers_semiglobal_strips": SassSpec("myers_stripsEP", "LDS.U8", words=32),
    "myers_global_strips": SassSpec("global31_stripsEP", "LDS.U8", words=32),
    "myers_semiglobal_wave": SassSpec("myers_strips_waveEP", "SHFL.IDX", words=32),
    "myers_global_wave": SassSpec("global31_strips_waveEP", "SHFL.IDX", words=32),
    # the query code from the row staged in shared memory, one a column: the
    # generic column loops (the window's loads, at each batch's top, lie
    # outside them) and the loop of unrolled whole batches (32 columns a
    # trip, the window's loads once in it); the dual kernel's B-only columns
    # are its cheapest
    "banded_stream": SassSpec("banded_stream_kernelILb0ELb{wide}E", "LDS.U8", 1, every=False),
    "banded_stream_dual": SassSpec("banded_stream_kernelILb1ELb{wide}E", "LDS.U8", 1,
                                   every=False),
    # the Peq-carry kernel is the dual kernel's body on its own slots (the
    # initial window, the injection stream built at each batch's top): the
    # query code from the staged row, one a column
    "banded": SassSpec("banded_peq_kernelILb{wide}E", "LDS.U8", 1, every=False),
    # the query code from the row staged in shared memory
    "banded_stream_packed": SassSpec("banded_packed_kernelILi{n_sub}E", "LDS.U8", 1, every=False),
    "int_peak": SassSpec("int_peak_kernelILi{chains}E", None),
    # two query codes and the checkpoint flag a pair column
    "banded_stream_pair": SassSpec("banded_stream_pair_kernel", _CODE, 3, every=False),
    # the probes: no early exit; static_c and noload load no query code, and
    # their column loop is pinned at PEAK_UNROLL columns a trip
    "banded_probe_full": SassSpec("banded_probe_kernelILi0E", _CODE, 1, every=False),
    "banded_probe_static_c": SassSpec("banded_probe_kernelILi1E", None),
    "banded_probe_noload": SassSpec("banded_probe_kernelILi2E", None),
    "banded_packed_pair": SassSpec("banded_packed_pair_kernelILi{n_sub}E", _CODE, 2, every=False),
}


@functools.lru_cache(maxsize=None)
def sass_text(path: str) -> str | None:
    """``cuobjdump -sass`` of the library at ``path``; None where the CUDA
    toolkit has no cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True,
                          timeout=300).stdout


def sass_functions(text: str) -> dict:
    """{mangled name: [(address, guard, opcode, operands), ...]} of a SASS listing."""
    heads = list(re.finditer(r"Function : (\S+)", text))
    out = {}
    for i, head in enumerate(heads):
        body = text[head.end():heads[i + 1].start() if i + 1 < len(heads) else len(text)]
        out[head.group(1)] = [(int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3),
                               m.group(4).strip()) for m in _LINE.finditer(body)]
    return out


def find_function(functions: dict, pattern: str) -> list:
    """The instructions of the one function whose name ``pattern`` (a
    regular expression) finds."""
    names = [name for name in functions if re.search(pattern, name)]
    if len(names) != 1:
        raise ValueError(f"{len(names)} SASS functions match {pattern!r}")
    return functions[names[0]]


def pipe(opcode: str) -> tuple:
    """The pipes an instruction occupies: always issue, and alu or fma."""
    base = opcode.split(".")[0]
    return ("issue", "alu") if base in ALU_PIPE else ("issue", "fma") if base in FMA_PIPE \
        else ("issue",)


def _target(ins) -> int | None:
    """A branch's target address, else None."""
    if not ins[2].startswith("BRA"):
        return None
    m = re.search(r"0x([0-9a-f]+)", ins[3])
    return int(m.group(1), 16) if m else None


def _loops(ins) -> list:
    """(first, last) instruction indices of every loop: a backward branch."""
    index = {x[0]: i for i, x in enumerate(ins)}
    return [(index[t], i) for i, x in enumerate(ins)
            if (t := _target(x)) is not None and t <= x[0] and t in index]


def _trip(body, every: bool, anchor: str | None) -> dict:
    """Instructions per pipe of one trip through a loop body (its last
    instruction the back edge): every instruction on the path where each
    conditional branch falls through, or (``every`` False) the shortest
    path with only the query-code checks (``ISETP.GT.U32 Px, ..., code,
    0x4``) falling through."""
    n = len(body)
    index = {x[0]: i for i, x in enumerate(body)}
    codes = {x[3].split(",")[0] for x in body if x[2] == anchor}
    checks = {f"@{m.group(1)}" for x in body if x[2].startswith("ISETP.GT.U32")
              and (m := re.match(r"(P\d), PT, (R\d+), 0x4, PT$", x[3])) and m.group(2) in codes}
    out = {}
    for p in PIPE_RATES:
        dist = [float("inf")] * (n + 1)
        for i in reversed(range(n)):
            x = body[i]
            w = 1 if p in pipe(x[2]) else 0
            if i == n - 1:
                dist[i] = w
                continue
            t = _target(x)
            taken = index.get(t) if t is not None and t > x[0] else None
            if t is None or t <= x[0]:  # not a branch, or an inner loop's back edge
                succ = [i + 1]
            elif x[1] in ("", "@PT"):  # unconditional
                succ = [taken]
            elif every or x[1] in checks:
                succ = [i + 1]
            else:
                succ = [i + 1, taken]
            dist[i] = w + min((dist[s] for s in succ if s is not None), default=float("inf"))
        out[p] = dist[0]
    return out


def column_instructions(ins, spec: SassSpec) -> dict:
    """Instructions per pipe of one column (one thread, one query character;
    for the peak kernel one step of every chain; for BitPAl's tiled kernel
    one word of one column; over ``spec.words``, for the Myers strip kernels
    one word of one column) of the kernel instance ``ins``: the cheapest of
    its column loops, one trip over the columns it holds. A loop nested in a
    column loop counts one trip, where the path goes through it (the packed
    banded kernel's window load, once every 32 columns, which the shortest
    path skips): its trips are not in the SASS, and fewer keep the count a
    floor."""
    loops = _loops(ins)

    def anchors(lo, hi):
        return sum(1 for x in ins[lo:hi + 1] if x[2] == spec.anchor)

    if spec.anchor is None:  # the largest innermost loop holds PEAK_UNROLL columns
        innermost = [(lo, hi) for lo, hi in loops
                     if not any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in loops)]
        lo, hi = max(innermost, key=lambda lh: lh[1] - lh[0])
        trip = _trip(ins[lo:hi + 1], True, None)
        return {p: v / PEAK_UNROLL for p, v in trip.items()}
    column_loops = [(lo, hi) for lo, hi in loops if anchors(lo, hi)
                    and not any(lo <= a and b <= hi and (a, b) != (lo, hi) and anchors(a, b)
                                for a, b in loops)]
    if not column_loops:
        raise ValueError(f"no loop loads {spec.anchor}")
    best = None
    for lo, hi in column_loops:
        trip = _trip(ins[lo:hi + 1], spec.every, spec.anchor)
        cols = anchors(lo, hi) / spec.anchors * spec.words
        per_column = {p: v / cols for p, v in trip.items()}
        best = per_column if best is None else {p: min(best[p], per_column[p]) for p in best}
    return best


def instruction_bound(per_column: dict, columns: float, sms: int,
                      clock_mhz: float) -> tuple[float, float, str]:
    """(instructions, their rate per second, pipe) of the slowest pipe for
    ``columns`` thread-columns at ``per_column`` instructions each, every SM
    at ``clock_mhz``: feed the first two to ``bound``."""
    per_s = {p: rate * sms * clock_mhz * 1e6 for p, rate in PIPE_RATES.items()}
    slowest = max(PIPE_RATES, key=lambda p: per_column[p] / per_s[p])
    return per_column[slowest] * columns, per_s[slowest], slowest


# -- the peak kernel -----------------------------------------------------------


def int_peak_ref(x: torch.Tensor, *, steps: int, unroll: int) -> torch.Tensor:
    """Plain torch version. x (chains + 1, n) int32 (row ``chains`` is b) ->
    (n,) int32: ``scripts/roofline.py::_peak_kernel``'s recurrence in int32
    words, the right shift masked (int32 shifts are arithmetic)."""
    chains = x.shape[0] - 1
    vs = [x[j] for j in range(chains)]
    b = x[chains]
    for _ in range(steps * unroll):
        for j in range(chains):
            a = vs[j] + b
            a = a ^ ((a >> 1) & 0x7FFFFFFF)
            a = a | b
            a = a & (a << 1)
            vs[j] = ~a
    acc = vs[0]
    for v in vs[1:]:
        acc = acc ^ v
    return acc


def int_peak(x: torch.Tensor, *, steps: int, unroll: int) -> torch.Tensor:
    """(chains + 1, n) int32 -> (n,) int32 after steps * unroll iterations of
    every chain. CPU tensors run the plain version; CUDA tensors launch
    ``csrc/int_peak.cu`` (chains 1, 2, 4, 8, 16 or 32)."""
    if x.dim() != 2 or x.shape[0] < 2 or x.dtype != torch.int32:
        raise ValueError(f"x must be (chains + 1, n) int32, got {tuple(x.shape)} {x.dtype}")
    if steps < 0 or unroll < 1:
        raise ValueError(f"need steps >= 0 and unroll >= 1, got {steps}, {unroll}")
    if x.device.type == "cpu":
        return int_peak_ref(x, steps=steps, unroll=unroll)
    if x.device.type != "cuda":
        raise ValueError(f"no int_peak for device {x.device}")
    return _launch(x, steps * unroll)


def _launch(x: torch.Tensor, iters: int) -> torch.Tensor:
    global LAUNCHES
    from .ops import build

    kernels = build.load()
    chains, n = x.shape[0] - 1, x.shape[1]
    if not kernels.lib.bgsa_int_peak_supports(chains):
        raise ValueError(f"the int_peak kernel takes 1, 2, 4, 8, 16 or 32 chains, got {chains}")
    x = x.contiguous()
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = kernels.lib.bgsa_int_peak(x.data_ptr(), out.data_ptr(), chains, n, iters, stream)
    kernels.check(rc, "int_peak")
    LAUNCHES += 1
    return out


def peak_inputs(chains: int, n: int, device) -> torch.Tensor:
    """The microbenchmark's input, as ``scripts/roofline.py`` makes it:
    arange | 1, (chains + 1, n) int32."""
    return (torch.arange((chains + 1) * n, dtype=torch.int32, device=device) | 1).reshape(
        chains + 1, n)


def sm_clock_mhz() -> float:
    """The SM clock's maximum, as ``nvidia-smi --query-gpu=clocks.max.sm`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


def sm_count(device="cuda") -> int:
    """The card's streaming multiprocessors (132 on the H100 SXM)."""
    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count


def derived_int32_peak(clock_mhz: float, sms: int) -> float:
    """int32 results per second one pipe gives: SMs x 64 x clock."""
    return sms * INT32_PER_CLOCK_PER_SM * clock_mhz * 1e6


def measure_int32_peak(*, chains: int = 8, steps: int = 1024, unroll: int = 16) -> dict:
    """Time the peak kernel on the card by CUDA events (median of 5 after a
    warm-up) at ``steps`` and at ``2 * steps``; the elements fill every SM
    four times over at 2048 threads per SM. Returns the source-op rate
    (``ops_per_s``), both times and their ratio (``linearity``), the input
    ``x`` and the output of the last launch at ``steps`` (``out``)."""
    n = sm_count() * 2048 * 4
    x = peak_inputs(chains, n, "cuda")

    def median_ms(s):
        out = int_peak(x, steps=s, unroll=unroll)  # warm-up
        times = []
        for _ in range(5):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = int_peak(x, steps=s, unroll=unroll)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return sorted(times)[len(times) // 2], out

    (ms, out), (ms_double, _) = median_ms(steps), median_ms(2 * steps)
    ops = PEAK_OPS_PER_CHAIN_ITER * chains * steps * unroll * n
    return {"chains": chains, "elements": n, "steps": steps, "unroll": unroll, "ops": ops,
            "ms": ms, "ms_double": ms_double, "linearity": ms_double / ms,
            "ops_per_s": ops / (ms * 1e-3), "bytes": 4 * (chains + 2) * n, "x": x, "out": out}
