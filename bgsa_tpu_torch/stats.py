"""Run statistics and GCUPS accounting.

Mirrors the reference's end-of-run report (``cal_cpu.c:459-475``):
``cal GCUPS`` counts kernel time only, ``Total GCUPS`` is end-to-end, both
with cells = ref_len * ref_count * read_len * subject_count.

The port's own copy of ``bgsa_tpu.stats``, same behaviour.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RunStats:
    query_len: int = 0
    query_count: int = 0
    subject_len: int = 0
    subject_count: int = 0  # real subjects (pads excluded)
    read_time: float = 0.0
    pack_time: float = 0.0
    cal_time: float = 0.0
    write_time: float = 0.0
    compile_time: float = 0.0  # XLA compile (no reference analogue)
    total_time: float = 0.0
    # Per-bucket kernel+fetch seconds (the reference's use_times matrix,
    # cal_all.c:318-321 — the input to its dynamic load balancer; feed these
    # to parallel.multihost.DynamicBalancer for heterogeneous deployments).
    bucket_cal_times: list = dataclasses.field(default_factory=list)
    # -D mode: the ratio schedule actually used, one row per computed bucket
    # (the reference prints device_compute_ratio per round, global.c:66-68).
    dynamic_ratios: list = dataclasses.field(default_factory=list)

    @property
    def cells(self) -> int:
        return self.query_len * self.query_count * self.subject_len * self.subject_count

    def gcups(self, seconds: float) -> float:
        return self.cells / seconds / 1e9 if seconds > 0 else float("inf")

    def to_json(self) -> str:
        import json

        d = dataclasses.asdict(self)
        d["cal_gcups"] = self.gcups(self.cal_time) if self.cal_time > 0 else None
        d["total_gcups"] = (
            self.gcups(self.total_time) if self.total_time > 0 else None
        )
        return json.dumps(d, allow_nan=False)

    def report(self) -> str:
        lines = [
            f"read_total_time  is {self.read_time:.2f}s",
            f"write_total_time is {self.write_time:.2f}s",
            f"mem_total_time is   {self.pack_time:.2f}s",
            "",
            f"query_len    is {self.query_len}",
            f"query_count  is {self.query_count}",
            f"subject_len   is {self.subject_len}",
            f"subject_count is {self.subject_count}",
            "",
            f"compile_time        is {self.compile_time:.2f}s",
            f"cal_total_times     is {self.cal_time:.2f}s",
            f"total time          is {self.total_time:.2f}s",
            f"cal GCUPS is {self.gcups(self.cal_time):.2f}",
            f"Total GCUPS is {self.gcups(self.total_time):.2f}",
        ]
        return "\n".join(lines)
