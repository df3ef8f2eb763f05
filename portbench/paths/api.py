"""The ``api`` path: one job is one ``bgsa_tpu_torch.align`` call in memory,
on uint8 code arrays, by one caller in a closed loop (the next call starts
when the last one has returned its numpy array). The calls cycle through
the workload's pool of subject batches with the same queries. Every call's
array is kept, and after the window every answer of every call is judged
against the reference's answers for its batch.
"""

from __future__ import annotations

import numpy as np

from .. import check


class Path:
    def __init__(self, workload: dict, config: dict, inputs, workdir: str, device: str):
        self.workload, self.config, self.inputs = workload, config, inputs
        self.kind = check.kind_of(config)
        import bgsa_tpu_torch

        kwargs = {"device": device}
        if self.kind == "banded":
            kwargs["k"] = config["k"]
        else:
            sc = config["scoring"]
            kwargs["scoring"] = bgsa_tpu_torch.Scoring(sc["match"], sc["mismatch"], sc["gap"])
            kwargs["mode"] = bgsa_tpu_torch.Mode(config["mode"])
        self.align, self.kwargs = bgsa_tpu_torch.align, kwargs
        self.outputs = []  # (batch index, the call's array)
        self.launches = [(workload["queries"], workload["subjects"])]  # one kernel launch a call

    def job(self, index: int) -> dict:
        batch = index % len(self.inputs.pool)
        out = self.align(self.inputs.queries, self.inputs.pool[batch], **self.kwargs)
        self.outputs.append((batch, out))
        return {}

    def warm(self) -> None:
        for i in range(2):
            self.job(i)
        self.outputs.clear()

    def check(self, seed: int, device) -> tuple:
        """(name -> (reading, limit), answers compared): every answer of every
        call against the reference's for its batch, and every call's
        array shape and type."""
        w, k = self.workload, self.config["k"]
        _, _, wanted = answers(w, self.config, self.inputs, device)
        dtype = np.int8 if self.kind == "banded" else np.int16
        shape_errors = wrong = 0
        for batch, out in self.outputs:
            out = np.asarray(out)
            if out.shape != (w["queries"], w["subjects"]) or out.dtype != dtype:
                shape_errors += 1
                wrong += wanted[batch].numel()
                continue
            wrong += check.mismatches(self.kind, k, wanted[batch], out)
        compared = sum(wanted[b].numel() for b, _ in self.outputs)
        return {"shape_errors": (shape_errors, 0), "score_mismatches": (wrong, 0)}, compared


def answers(workload: dict, config: dict, inputs, device):
    """(q, s, the reference's answers for every pair of each batch)."""
    q, s = check.sample_pairs(workload["queries"], workload["subjects"], 0, None)
    kind, k = check.kind_of(config), config["k"]
    return q, s, [check.want(kind, k, inputs.queries, subjects, q, s, device)
                  for subjects in inputs.pool]


def control(workload: dict, config: dict, inputs, seed: int, device) -> tuple:
    """The control's readings: its answers for each batch of the pool
    (every call on a batch asks the same), judged as a run judges them."""
    kind, k = check.kind_of(config), config["k"]
    q, s, wanted = answers(workload, config, inputs, device)
    wrong = 0
    for subjects, want in zip(inputs.pool, wanted):
        got = check.control_answers(config["control"], kind, k, inputs.queries, subjects,
                                    q, s, want)
        wrong += check.mismatches(kind, k, want, got)
    return {"score_mismatches": (wrong, 0)}, sum(x.numel() for x in wanted)
