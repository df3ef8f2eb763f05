"""The ``cli_scored`` path: ``cli``'s job for a configuration of general
integer scoring (BitPAl), checked against ``reference_scored``.

A job is one ``bgsa-torch-align -M <match> -I <mismatch> -G <gap>`` run over
the workload's files, driven in-process through ``cli.align_main``, as the
``cli`` path drives it, and the result pair and stats are removed before
each job the same way. The check reads the last job's int16 result with
``check.read_result`` and compares every query against ``check_subjects``
sampled subjects with the reference's optimal global scores, worked out on
the run's device in blocks of ``check.PAIR_CELLS`` DP cells. Every answer
must be exact.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import check, reference_scored, traffic
from . import cli


def scheme(config: dict) -> tuple[int, int, int]:
    """(match, mismatch, gap) of a global configuration."""
    if config["mode"] != "global":
        raise ValueError(f"the scored reference is global only, not {config['mode']!r}")
    sc = config["scoring"]
    return sc["match"], sc["mismatch"], sc["gap"]


class Path(cli.Path):
    def __init__(self, workload: dict, config: dict, inputs, workdir: str, device: str):
        self.workload, self.config, self.inputs = workload, config, inputs
        match, mismatch, gap = scheme(config)
        self.query_file = os.path.join(workdir, "query.txt")
        self.subject_file = os.path.join(workdir, "subject.txt")
        self.result = os.path.join(workdir, "result.bin")
        self.stats = os.path.join(workdir, "stats.json")
        traffic.write_lines(self.query_file, inputs.queries)
        traffic.write_lines(self.subject_file, inputs.pool[0])
        self.argv = ["-q", self.query_file, "-d", self.subject_file, "-f", self.result,
                     "--stats-json", self.stats, "--quiet", "--device", device,
                     "-M", str(match), "-I", str(mismatch), "-G", str(gap)]
        from bgsa_tpu_torch import cli as port_cli

        self.align_main = port_cli.align_main
        self.launches = []

    def check(self, seed: int, device) -> tuple:
        """(name -> (reading, limit), answers compared): the last job's
        result pair against the reference on the sampled pairs."""
        w = self.workload
        layout, result = check.read_result(self.result, w["queries"], w["subjects"], np.int16)
        q, s = cli.pairs(w, seed)
        if result is None:
            wrong = len(q)
        else:
            self.launches = result.launches
            wrong = mismatches(want(self.config, self.inputs, q, s, device), result.scores(q, s))
        return {"layout_errors": (layout, 0), "score_mismatches": (wrong, 0)}, len(q)


def want(config: dict, inputs, q, s, device) -> torch.Tensor:
    """The reference's scores for the pairs (queries[q], subjects[s]), on the
    CPU: worked out on ``device`` a block of pairs at a time."""
    match, mismatch, gap = scheme(config)
    queries, subjects = inputs.queries, inputs.pool[0]
    block = max(1, check.PAIR_CELLS // (subjects.shape[1] + 1))
    out = []
    for lo in range(0, len(q), block):
        qs = torch.from_numpy(queries[q[lo:lo + block]]).to(device)
        ss = torch.from_numpy(subjects[s[lo:lo + block]]).to(device)
        out.append(reference_scored.global_scores(qs, ss, match, mismatch, gap).cpu())
    return torch.cat(out) if out else torch.empty(0, dtype=torch.int32)


def mismatches(wanted: torch.Tensor, got) -> int:
    """How many of the answers ``got`` differ from the reference's."""
    got = torch.as_tensor(np.asarray(got)).reshape(-1).to(torch.int32)
    if got.numel() != wanted.numel():
        return wanted.numel()
    return int((got != wanted).sum())


def control(workload: dict, config: dict, inputs, seed: int, device) -> tuple:
    """The configuration's control in the program's place, on the pairs a run
    compares: (name -> (reading, limit), answers). "ungapped": the
    substitution score alone, as a kernel that ignores indels would give."""
    if config["control"] != "ungapped":
        raise ValueError(f"no control {config['control']!r}")
    match, mismatch, _ = scheme(config)
    q, s = cli.pairs(workload, seed)
    wanted = want(config, inputs, q, s, device)
    got = reference_scored.ungapped(torch.from_numpy(inputs.queries[q]),
                                    torch.from_numpy(inputs.pool[0][s]), match, mismatch)
    return {"score_mismatches": (mismatches(wanted, got), 0)}, len(q)
