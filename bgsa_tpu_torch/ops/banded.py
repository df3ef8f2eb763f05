"""Banded Myers verification (error threshold k): torch and CUDA.

Counterpart of ``bgsa_tpu/ops/banded.py``, same I/O contracts, with 32-bit
words held as int32 (``bgsa_tpu_torch.pack``) and scores (Q, S) int32 error
counts, 127 (``MAX_ERROR``) meaning "over budget":

* ``banded_stream``: one flat Eq bit-stream (5, W, S) per subject
  (``pack.pack_banded_stream``), for s_len >= q_len;
* ``banded_stream_dual``: two streams (2, 5, W, S), preload A and
  injections B (``pack.pack_banded_streams``), for s_len < q_len, 2k <= 63;
* ``banded``: the Peq-carry kernel on the initial window and injection
  words (``pack.pack_banded``), for the rest.

Each ``*_ref`` is the plain torch version: the JAX column body with the
queries as a batch dimension, the band register as native int64 (the TPU's
(lo, hi) uint32 pairs become one word). int64 ``>>`` is arithmetic, so every
right shift goes through ``shr``. Each wrapper runs its plain version for a
CPU tensor and launches its hand-written kernel (``csrc/banded.cu``) for a
CUDA tensor, counting launches in ``LAUNCHES[name]``.

The geometry helpers (``geometry``, ``chk_array``) mirror the JAX module's
``_geometry``/``_chk_array``, which cannot be imported here: that module
imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..banded_ref import MAX_ERROR, checkpoint_columns
from ..pack import CHAR_NUM

WORD_BITS = 32
MASK32 = 0xFFFFFFFF

# Kernel launches per wrapper (CUDA tensors only).
LAUNCHES = {"banded_stream": 0, "banded_stream_dual": 0, "banded": 0}


def geometry(q_len: int, s_len: int, k: int) -> tuple[int, int, int]:
    """(h, band_down, max_err) of a banded geometry; raises ValueError where
    ``bgsa_tpu.ops.banded._geometry`` does."""
    h = k + s_len - q_len
    if h < 0:
        raise ValueError("banded requires subject_len >= query_len - threshold")
    band_length = k + h + 1
    if band_length > 64:
        raise ValueError(f"band of {band_length} bits exceeds the 64-bit register")
    if k + min(k, s_len) > 63:
        # the initial Peq window holds subject[0..k-1] at bits k+1..2k
        raise ValueError(
            f"banded preload needs bit {k + min(k, s_len)} (> 63): threshold "
            f"{k} with {s_len}bp subjects exceeds the 64-bit band register "
            "(undefined in the reference too); reduce -k or use full Myers"
        )
    return h, band_length - 1, k + h + 1


def chk_array(q_len: int, s_len: int, k: int) -> np.ndarray:
    """(q_len,) int32, 1 at column t when the reference checks err after it."""
    chk = np.zeros(q_len, np.int32)
    for c in checkpoint_columns(q_len, s_len, k):
        if 1 <= c <= q_len:
            chk[c - 1] = 1
    return chk


def last_checkpoint(q_len: int, s_len: int, k: int) -> int:
    return max(checkpoint_columns(q_len, s_len, k), default=0)


def const64(x: int) -> int:
    """The int64 holding the 64 bits of ``x`` in [0, 2**64) (1 << 63 is no
    int64 literal)."""
    return int(np.uint64(x).view(np.int64))


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 words by 0 <= n < 64."""
    return x if n == 0 else (x >> n) & ((1 << (64 - n)) - 1)


def words64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two 32-bit words held as int32 -> the int64 word (hi << 32) | lo."""
    return (hi.long() << 32) | (lo.long() & MASK32)


def _padded_stream(stream: torch.Tensor, q_len: int) -> torch.Tensor:
    """(..., W, S) int32 words -> int64 words zero-padded to the last word a
    column window reads (the kernels read 0 past W)."""
    need = (q_len - 1) // WORD_BITS + 3
    st = stream.long() & MASK32
    if st.shape[-2] < need:
        pad = st.new_zeros(st.shape[:-2] + (need - st.shape[-2], st.shape[-1]))
        st = torch.cat([st, pad], dim=-2)
    return st


def _window(st: torch.Tensor, c: torch.Tensor, t: int) -> torch.Tensor:
    """Column t's 64-bit window of stream words st (5, W', S) int64 for the
    query characters c (Q,) -> (Q, S): stream bits [t, t + 63]."""
    w, b = divmod(t, WORD_BITS)
    lo = st[:, w] | (st[:, w + 1] << 32)
    if b:
        lo = shr(lo, b) | (st[:, w + 2] << (64 - b))
    return lo[c]


def _band_update(eq, vp, vn):
    """One column of the band recurrence -> (vp, vn, d0)."""
    x = eq | vn
    d0 = (((x & vp) + vp) ^ vp) | x
    hn = d0 & vp
    hp = ~(d0 | vp) | vn
    xs = shr(d0, 1)
    return ~(hp | xs) | hn, xs & hp, d0


def _epilogue(vp, vn, err, dead, h):
    cur = mn = err
    for i in range(h + 1):
        cur = cur + ((vp >> i) & 1) - ((vn >> i) & 1)
        mn = torch.minimum(mn, cur)
    return torch.where(dead, MAX_ERROR, mn).to(torch.int32)


def _scan(queries, S, window_at, *, q_len, s_len, k, live=None):
    """Run the band over the columns for (Q, S) pairs: window_at(c, t) gives
    column t's Eq window (Q, S) int64 for the query characters c (Q,).
    ``live``, a list, receives the count of pairs not yet over budget before
    each column (the work the reference's checkpoints leave to do)."""
    h, _, max_err = geometry(q_len, s_len, k)
    chk = chk_array(q_len, s_len, k)
    q = queries.long()
    vp = vn = torch.zeros((q.shape[0], S), dtype=torch.int64, device=q.device)
    err = torch.full_like(vp, k)
    dead = torch.zeros_like(vp, dtype=torch.bool)
    for t in range(q_len):
        if live is not None:
            live.append(int(dead.numel() - dead.sum()))
        vp, vn, d0 = _band_update(window_at(q[:, t], t), vp, vn)
        if t >= k:
            err = err + 1 - (d0 & 1)
        if chk[t]:
            dead = dead | (err > max_err)
    return _epilogue(vp, vn, err, dead, h)


def banded_stream_ref(stream, queries, *, q_len: int, s_len: int, k: int, live=None):
    """Plain torch version. stream (5, W, S) int32, queries (Q, m) -> (Q, S)
    int32. ``live``: see ``_scan``."""
    _, band_down, _ = geometry(q_len, s_len, k)
    st = _padded_stream(stream, q_len)
    mask = const64((1 << (band_down + 1)) - 1)
    return _scan(queries.to(stream.device), stream.shape[-1],
                 lambda c, t: _window(st, c, t) & mask, q_len=q_len, s_len=s_len, k=k,
                 live=live)


def banded_stream_dual_ref(streams, queries, *, q_len: int, s_len: int, k: int):
    """Plain torch version. streams (2, 5, W, S) int32 (preload A, injections
    B), queries (Q, m) -> (Q, S) int32. Column t's register is
    A[t + j] | (B[t + j] & (j <= band_down)); A is empty past position 2k."""
    _, band_down, _ = geometry(q_len, s_len, k)
    st = _padded_stream(streams, q_len)
    mask = const64((1 << (band_down + 1)) - 1)

    def window_at(c, t):
        eq = _window(st[1], c, t) & mask
        return eq | _window(st[0], c, t) if t <= 2 * k else eq

    return _scan(queries.to(streams.device), streams.shape[-1], window_at,
                 q_len=q_len, s_len=s_len, k=k)


def banded_ref(init_lo, init_hi, inj, queries, *, q_len: int, s_len: int, k: int):
    """Plain torch version of the Peq-carry kernel (``banded_xla``).
    init_lo/init_hi (5, S) int32, inj (5, W, S) int32, queries (Q, m) ->
    (Q, S) int32. The five Peq planes shift right one bit per column and take
    column t's injection bit at band_down while t < q_len - k."""
    _, band_down, _ = geometry(q_len, s_len, k)
    W = inj.shape[1]
    peq = words64(init_lo, init_hi)  # (5, S)
    injw = inj.long() & MASK32

    def window_at(c, t):
        nonlocal peq
        if t:  # column t - 1's shift and injection
            peq = shr(peq, 1)
            if t - 1 < q_len - k:
                w, b = min((t - 1) // WORD_BITS, W - 1), (t - 1) % WORD_BITS
                peq = peq | (((injw[:, w] >> b) & 1) << band_down)
        return peq[c]

    return _scan(queries.to(init_lo.device), init_lo.shape[-1], window_at,
                 q_len=q_len, s_len=s_len, k=k)


def _check_words(x, shape_desc: str, ndim: int, name: str) -> None:
    """x must be int32 words of ndim dimensions, characters on axis ndim - 3
    (axis 0 for the (5, S) windows)."""
    if x.dim() != ndim or x.shape[max(ndim - 3, 0)] != CHAR_NUM or x.dtype != torch.int32:
        raise ValueError(f"{name} must be {shape_desc} int32, got {tuple(x.shape)} {x.dtype}")


def _check_queries(queries, q_len: int) -> None:
    if queries.dim() != 2 or queries.shape[1] != q_len:
        raise ValueError(f"queries must be (Q, {q_len}), got {tuple(queries.shape)}")


def _device_of(x, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} for device {x.device}")
    return x.device.type


def _upload_chk(q_len: int, s_len: int, k: int, device) -> torch.Tensor:
    """The checkpoint flags as a (q_len,) uint8 device tensor, uploaded from
    pinned memory without blocking the host."""
    host = torch.from_numpy(chk_array(q_len, s_len, k).astype(np.uint8))
    return host.pin_memory().to(device, non_blocking=True) if q_len else host.to(device)


def launch(name: str, fn_name: str, out: torch.Tensor, args) -> None:
    """Call the C entry point ``fn_name`` with ``args`` and the current
    stream of ``out``'s device; raise on a CUDA error."""
    from . import build

    kernels = build.load()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = getattr(kernels.lib, fn_name)(*args, stream)
    kernels.check(rc, name)


def _launch_stream(name, stream, queries, *, q_len, s_len, k, dual):
    h, band_down, max_err = geometry(q_len, s_len, k)
    W, S = stream.shape[-2:]
    Q = queries.shape[0]
    dev = stream.device
    out = torch.empty((Q, S), dtype=torch.int32, device=dev)
    if Q == 0 or S == 0:
        return out
    stream = stream.contiguous()
    q = queries.to(device=dev, dtype=torch.uint8).contiguous()
    chk = _upload_chk(q_len, s_len, k, dev)
    args = (stream.data_ptr(), q.data_ptr(), chk.data_ptr(), out.data_ptr(),
            Q, q_len, W, S, k, h, band_down, max_err, last_checkpoint(q_len, s_len, k),
            int(dual))
    launch(name, "bgsa_banded_stream", out, args)
    LAUNCHES[name] += 1
    return out


def banded_stream(stream, queries, *, q_len: int, s_len: int, k: int):
    """(5, W, S) int32 Eq bit-stream x (Q, q_len) codes -> (Q, S) int32
    error counts (127 = over budget). Needs s_len >= q_len."""
    _check_words(stream, "(5, W, S)", 3, "stream")
    _check_queries(queries, q_len)
    h, _, _ = geometry(q_len, s_len, k)
    if h < k:
        raise ValueError(
            "banded_stream requires s_len >= q_len (the preload would exceed "
            "the band); use banded() for shorter subjects"
        )
    if _device_of(stream, "banded_stream") == "cpu":
        return banded_stream_ref(stream, queries, q_len=q_len, s_len=s_len, k=k)
    return _launch_stream("banded_stream", stream, queries, q_len=q_len, s_len=s_len, k=k,
                          dual=False)


def banded_stream_dual(streams, queries, *, q_len: int, s_len: int, k: int):
    """(2, 5, W, S) int32 Eq bit-streams (preload, injections) x (Q, q_len)
    codes -> (Q, S) int32 error counts. For s_len < q_len; needs 2k <= 63."""
    _check_words(streams, "(2, 5, W, S)", 4, "streams")
    if streams.shape[0] != 2:
        raise ValueError(f"streams must be (2, 5, W, S), got {tuple(streams.shape)}")
    _check_queries(queries, q_len)
    geometry(q_len, s_len, k)
    if 2 * k > 63:
        raise ValueError(
            "banded_stream_dual requires 2k <= 63 (preload must fit the "
            "64-bit window); use banded()"
        )
    if _device_of(streams, "banded_stream_dual") == "cpu":
        return banded_stream_dual_ref(streams, queries, q_len=q_len, s_len=s_len, k=k)
    return _launch_stream("banded_stream_dual", streams, queries, q_len=q_len, s_len=s_len,
                          k=k, dual=True)


def banded(init_lo, init_hi, inj, queries, *, q_len: int, s_len: int, k: int):
    """Peq-carry kernel: initial window halves (5, S) int32 and injection
    words (5, W, S) int32 x (Q, q_len) codes -> (Q, S) int32 error counts."""
    _check_words(init_lo, "(5, S)", 2, "init_lo")
    _check_words(init_hi, "(5, S)", 2, "init_hi")
    _check_words(inj, "(5, W, S)", 3, "inj")
    if init_hi.shape != init_lo.shape or inj.shape[-1] != init_lo.shape[-1]:
        raise ValueError("init_lo, init_hi and inj must cover the same subjects")
    if init_hi.device != init_lo.device or inj.device != init_lo.device:
        raise ValueError("init_lo, init_hi and inj must lie on one device")
    _check_queries(queries, q_len)
    h, band_down, max_err = geometry(q_len, s_len, k)
    if _device_of(init_lo, "banded") == "cpu":
        return banded_ref(init_lo, init_hi, inj, queries, q_len=q_len, s_len=s_len, k=k)
    W, S = inj.shape[1:]
    Q = queries.shape[0]
    dev = init_lo.device
    out = torch.empty((Q, S), dtype=torch.int32, device=dev)
    if Q == 0 or S == 0:
        return out
    tensors = [x.contiguous() for x in (init_lo, init_hi, inj)]
    q = queries.to(device=dev, dtype=torch.uint8).contiguous()
    chk = _upload_chk(q_len, s_len, k, dev)
    args = (*(x.data_ptr() for x in tensors), q.data_ptr(), chk.data_ptr(), out.data_ptr(),
            Q, q_len, W, S, k, h, band_down, max_err, last_checkpoint(q_len, s_len, k))
    launch("banded", "bgsa_banded_peq", out, args)
    LAUNCHES["banded"] += 1
    return out
