"""The ``cli`` path: one job is one ``bgsa-torch-align`` run over the
workload's files, driven in-process through ``cli.align_main`` as a user's
command line gives it (``-q -d -f --stats-json --quiet``, ``-k`` for the
banded filter, ``-M -I -G`` and ``--semi-global`` for other schemes).

Every job reads the same two files and rewrites one result file, so the
result the window leaves is the last job's. The result pair and the stats
are removed before each job, so that a job that writes nothing leaves
nothing to read.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .. import check, traffic


class Path:
    def __init__(self, workload: dict, config: dict, inputs, workdir: str, device: str):
        self.workload, self.config, self.inputs = workload, config, inputs
        self.kind = check.kind_of(config)
        self.query_file = os.path.join(workdir, "query.txt")
        self.subject_file = os.path.join(workdir, "subject.txt")
        self.result = os.path.join(workdir, "result.bin")
        self.stats = os.path.join(workdir, "stats.json")
        traffic.write_lines(self.query_file, inputs.queries)
        traffic.write_lines(self.subject_file, inputs.pool[0])
        argv = ["-q", self.query_file, "-d", self.subject_file, "-f", self.result,
                "--stats-json", self.stats, "--quiet", "--device", device]
        if self.kind == "banded":
            argv += ["-k", str(config["k"])]
        else:
            sc = config["scoring"]
            argv += ["-M", str(sc["match"]), "-I", str(sc["mismatch"]), "-G", str(sc["gap"])]
            if config["mode"] == "semi-global":
                argv.append("--semi-global")
        self.argv = argv
        from bgsa_tpu_torch import cli

        self.align_main = cli.align_main
        self.launches = []

    def job(self, index: int) -> dict:
        for path in (self.result, self.result + ".info", self.stats):
            if os.path.exists(path):
                os.remove(path)
        rc = self.align_main(self.argv)
        if rc != 0:
            raise RuntimeError(f"bgsa-torch-align exited {rc}")
        with open(self.stats) as f:
            return {"stats": json.load(f)}

    def warm(self) -> None:
        self.job(-1)

    def check(self, seed: int, device) -> tuple:
        """(name -> (reading, limit), answers compared): the last job's
        result pair against the reference on the sampled pairs."""
        w, k = self.workload, self.config["k"]
        dtype = np.int8 if self.kind == "banded" else np.int16
        layout, result = check.read_result(self.result, w["queries"], w["subjects"], dtype)
        q, s = pairs(w, seed)
        if result is None:
            wrong = len(q)
        else:
            self.launches = result.launches
            wanted = check.want(self.kind, k, self.inputs.queries, self.inputs.pool[0], q, s,
                                device)
            wrong = check.mismatches(self.kind, k, wanted, result.scores(q, s))
        return {"layout_errors": (layout, 0), "score_mismatches": (wrong, 0)}, len(q)


def pairs(workload: dict, seed: int):
    """The pairs a run compares: every query against ``check_subjects``
    subjects drawn from the seed's check stream."""
    return check.sample_pairs(workload["queries"], workload["subjects"],
                              workload["check_subjects"], traffic.rng_for(seed, 1))


def control(workload: dict, config: dict, inputs, seed: int, device) -> tuple:
    """The readings of the configuration's control in the program's place,
    on the pairs a run compares: (name -> (reading, limit), answers)."""
    kind, k = check.kind_of(config), config["k"]
    q, s = pairs(workload, seed)
    queries, subjects = inputs.queries, inputs.pool[0]
    wanted = check.want(kind, k, queries, subjects, q, s, device)
    got = check.control_answers(config["control"], kind, k, queries, subjects, q, s, wanted)
    return {"score_mismatches": (check.mismatches(kind, k, wanted, got), 0)}, len(q)
