"""Device-mesh sharding of the 31-bit Myers scorer on torch devices.

Counterpart of ``bgsa_tpu/parallel/mesh.py``: subjects sharded over the
mesh's first axis, queries over its second, every shard scored on its own
device by ``ops.myers_pallas.myers_global`` (the kernel on a card, the plain
version on the CPU: the tensors' device picks, so there is no ``backend`` or
``interpret``), no collectives on the hot path. The scores come back as the
shards (``ShardedScores``, which ``np.asarray`` assembles) or, with
``merge=True``, gathered into one (Q, S) tensor on the mesh's first device,
the local counterpart of the JAX version's two ``all_gather``s.

A mesh's device list may repeat a device: ``make_mesh(["cpu"] * 8)`` (the
counterpart of the JAX tests' 8 virtual CPU devices) and ``make_mesh(["cuda:0"]
* 4, query_shards=2)`` (one card) run the whole split on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.myers_pallas import myers_global

SUBJECT_AXIS = "subjects"
QUERY_AXIS = "queries"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (subject shards, query shards) grid of torch devices."""

    devices: tuple  # devices[i][j]: subject shard i x query shard j
    axis_names: tuple = (SUBJECT_AXIS, QUERY_AXIS)

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.devices), len(self.devices[0])


def make_mesh(devices=None, query_shards: int = 1) -> Mesh:
    """(n / query_shards, query_shards) mesh over the given devices, or over
    every CUDA device (no CPU fallback: raises where there is none)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= (e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0 or n % query_shards:
        raise ValueError(f"{n} devices not divisible by query_shards={query_shards}")
    return Mesh(tuple(tuple(devices[i:i + query_shards]) for i in range(0, n, query_shards)))


def shard_inputs(eq: torch.Tensor, queries: torch.Tensor, mesh: Mesh):
    """Place eq (subject-sharded along S) and queries (sharded along Q) on the
    mesh: returns (eq_parts, query_parts), each indexed [i][j] by mesh
    position and lying on that position's device."""
    n_s, n_q = mesh.shape
    S, Q = eq.shape[2], queries.shape[0]
    if S % n_s or Q % n_q:
        raise ValueError(f"(Q={Q}, S={S}) does not split over a {n_s} x {n_q} mesh")
    eq_chunks = eq.chunk(n_s, dim=2) if S else [eq] * n_s
    q_chunks = queries.chunk(n_q, dim=0) if Q else [queries] * n_q
    eq_parts = [[eq_chunks[i].to(d) for d in row] for i, row in enumerate(mesh.devices)]
    q_parts = [[q_chunks[j].to(d) for j, d in enumerate(row)] for row in mesh.devices]
    return eq_parts, q_parts


@dataclasses.dataclass
class ShardedScores:
    """(Q, S) scores as the mesh's blocks: ``blocks[i][j]`` holds query shard
    j x subject shard i on device (i, j). ``np.asarray`` synchronizes and
    assembles them."""

    mesh: Mesh
    blocks: list

    def __array__(self, dtype=None, copy=None):
        cols = [np.concatenate([b.cpu().numpy() for b in row], axis=0) for row in self.blocks]
        host = np.concatenate(cols, axis=1)
        return host if dtype is None else host.astype(dtype, copy=False)


def myers_global_sharded(eq, queries, mesh: Mesh, *, read_len: int, factor: int = -1,
                         merge: bool = False):
    """Myers scores with subjects (and optionally queries) sharded over ``mesh``.

    The JAX version's ``word_bits`` has no counterpart: ``myers_global``
    takes 31-bit words only.

    Args:
      eq: (5, W, S) int32 31-bit Eq words; S divisible by the subject-axis size.
      queries: (Q, m) query codes; Q divisible by the query-axis size.
      merge: if True, gather the full (Q, S) scores onto the mesh's first device.

    Returns:
      (Q, S) int32 scores: a tensor if ``merge``, else ``ShardedScores``.
    """
    eq_parts, q_parts = shard_inputs(eq, queries, mesh)
    blocks = [[myers_global(eq_parts[i][j], q_parts[i][j], read_len=read_len,
                            factor=factor)
               for j in range(mesh.shape[1])] for i in range(mesh.shape[0])]
    if not merge:
        return ShardedScores(mesh, blocks)
    first = mesh.devices[0][0]
    return torch.cat([torch.cat([b.to(first) for b in row], dim=0) for row in blocks], dim=1)
