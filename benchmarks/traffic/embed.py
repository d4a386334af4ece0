"""Traffic kind `embed`: one closed-loop caller of `FFRNet.embed` on batches
of host uint8 aligned faces (N, 112, 112, 3), cycling a pool of distinct
batches drawn from the seed; each call ends with both embeddings on the
host.

Parameters (the traffic file): batch, pool, dtype (the served type),
trace_calls, attribution_calls. The pool is numpy arrays in pageable host
memory, as a caller's decoded images are. The configuration gives the model (float, or int8 with its
calibration faces drawn from the seed).

Correctness: every answer of the window against the plain reference's
embeddings of the same faces: `raw_gap` and `rect_gap`, the largest
1 - cos over every face of every call, for the raw and the rectified
embedding.
"""

from __future__ import annotations

import sys

import torch

from benchmarks.flops import embed_flops
from benchmarks.reference.numerics import tf32
from benchmarks.reference.serve import Reference, unit_range
from benchmarks.system import (ITEMSIZE, STREAM_CALIBRATION, STREAM_TRAFFIC, DriverBase,
                               cosine_gap, ranged, serving_model, uint8_images)


class Driver(DriverBase):
    program_state = ("model",)

    def __init__(self, run):
        from ffrnet_torch.ops.kernels import launch_counts

        super().__init__(run)
        tr, cfg = self.traffic, self.spec.config
        self.batch, self.pool_n, self.dtype = tr["batch"], tr["pool"], tr["dtype"]
        self.int8 = "int8" in cfg
        self.cal = None
        if self.int8:
            self.cal = uint8_images((cfg["int8"]["calibration_faces"], 112, 112, 3), run.seed,
                                    STREAM_CALIBRATION, self.dev).cpu().numpy()
        self.model = serving_model(cfg, self.dtype, run.seed, self.dev, self.cal)
        self.make_pool()
        run.info.update(batch=self.batch, itemsize=ITEMSIZE[self.dtype],
                        compute="int8" if self.int8 else self.dtype,
                        flops_per_call=embed_flops(self.batch))
        before = launch_counts()
        for k in range(self.pool_n):  # every shape this traffic uses, once
            self.invoke(k)
        after = launch_counts()
        per_call = {n: (after[n] - before[n]) / self.pool_n for n in after
                    if after[n] != before[n]}
        print(f"[benchmark] launches per call: {per_call}", file=sys.stderr)
        self.answers = {k: [] for k in range(self.pool_n)}

    def make_pool(self):
        faces = uint8_images((self.pool_n, self.batch, 112, 112, 3), self.run.seed,
                             STREAM_TRAFFIC, self.dev)
        self.pool = list(faces.cpu().numpy())

    def invoke(self, k):
        with self.span("embed call"):
            raw, rect = self.model.embed(self.pool[k])
        with self.span("fetch"):
            return raw.cpu(), rect.cpu()

    def call(self, i):
        k = i % self.pool_n
        self.answers[k].append(self.invoke(k))
        return self.batch

    def instrumented(self):
        import ffrnet_torch.ops.quant as quant

        return ranged(quant, ("quantize_activation", "to_nhwc"), "quantize")

    # ------------------------------------------------------- correctness
    def reference(self, precision="fp32"):
        return Reference(self.spec.config, self.run.seed, self.dev, precision, self.cal,
                         self.dtype)

    def reference_inputs(self, k):
        """The reference's [-1, 1] faces of pool batch k (the float values
        of what the program receives)."""
        return unit_range(torch.from_numpy(self.pool[k]).to(self.dev))

    def reference_answers(self, precision="fp32"):
        ref = self.reference(precision)
        with tf32(False):
            return {k: ref.embed(self.reference_inputs(k)) for k in range(self.pool_n)}

    def compare(self, answers, want):
        """-> ({number: value}, [(pool index, call, raw gap, rect gap)])."""
        rows = []
        for k, calls in answers.items():
            w_raw, w_rect = (t.double().cpu() for t in want[k])
            for j, (raw, rect) in enumerate(calls):
                rows.append((k, j, float(cosine_gap(raw.cpu(), w_raw).max()),
                             float(cosine_gap(rect.cpu(), w_rect).max())))
        return {"raw_gap": max(r[2] for r in rows), "rect_gap": max(r[3] for r in rows)}, rows

    def controls(self):
        """The readings of the cell's control: the reference in the
        program's place at the workload's `control` precision."""
        want = self.reference_answers()
        got = self.reference_answers(self.spec.workload["control"])
        return {"control": self.compare({k: [v] for k, v in got.items()}, want)[0]}

    def check(self):
        numbers, rows = self.compare(self.answers, self.reference_answers())
        lim = self.spec.workload["limits"]
        failed = sum(raw > lim["raw_gap"] or rect > lim["rect_gap"] for _, _, raw, rect in rows)
        return numbers, failed
