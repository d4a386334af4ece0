"""Traffic kind `ingest`: one closed-loop caller of `FFRNet.embed_canvas` on
batches of host uint8 RGB canvases with 5-point landmarks, cycling a pool
of distinct batches drawn from the seed; each call ends with both
embeddings on the host. The canvases' pixels are uniform; the landmarks
are ArcFace's reference points times `lmk_scale`, plus `lmk_offset`, plus
gaussian noise of `lmk_noise_px` (x, y), so that every face lies inside
the canvas and the alignment's guard can take the band warp.

Parameters (the traffic file): batch, pool, canvas (H, W), dtype,
lmk_scale, lmk_offset, lmk_noise_px, trace_calls, attribution_calls. The
canvases are numpy arrays in pageable host memory, as `embed_files`'s
decoded canvases are.

Correctness: `crop_gap`, the largest |difference| (0-255 pixels) between
the program's 112x112 crops and the reference's cp2tform + bilinear warp,
on one call per pool batch drawn from the seed; and `raw_gap`, `rect_gap`
as in `embed`, against the reference's embeddings of its own crops.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.bounds import warp_footprint_pixels
from benchmarks.reference import align
from benchmarks.reference.numerics import quant_act, tf32
from benchmarks.system import STREAM_LANDMARKS, STREAM_SAMPLE, STREAM_TRAFFIC, ranged, stream
from benchmarks.traffic.embed import Driver as EmbedDriver


class Driver(EmbedDriver):

    def make_pool(self):
        tr, n = self.traffic, self.pool_n
        h, w = tr["canvas"]
        canvas = torch.randint(0, 256, (n, self.batch, h, w, 3), dtype=torch.uint8,
                               device=self.dev, generator=torch.Generator(
                                   device=self.dev).manual_seed(
                                       stream(self.run.seed, STREAM_TRAFFIC)))
        self.pool = list(canvas.cpu().numpy())
        rng = np.random.default_rng(stream(self.run.seed, STREAM_LANDMARKS))
        self.lmk = list((align.ARCFACE_REF_PTS[None, None] * tr["lmk_scale"]
                         + rng.normal(0, tr["lmk_noise_px"], (n, self.batch, 5, 2))
                         + tr["lmk_offset"]).astype(np.float32))
        self.sampler = np.random.default_rng(stream(self.run.seed, STREAM_SAMPLE))
        self.seen = [0] * n
        self.crops = [None] * n

    def invoke(self, k):
        with self.span("embed call"):
            raw, rect, crops = self.model.embed_canvas(self.pool[k], self.lmk[k])
        with self.span("fetch"):
            out = raw.cpu(), rect.cpu()
        # one call per pool batch, drawn from the seed, keeps its crops
        self.seen[k] += 1
        if self.sampler.random() < 1.0 / self.seen[k]:
            self.crops[k] = crops
        return out

    def call(self, i):
        if i == 0:  # the window's draw starts afresh
            self.seen = [0] * self.pool_n
        return super().call(i)

    def instrumented(self):
        import ffrnet_torch.api as api

        return ranged(api, ("align_faces",), "align")

    def release(self):
        super().release()
        self.crops = [c.cpu() for c in self.crops]

    # ------------------------------------------------------- correctness
    def reference_crops(self, k):
        inv = align.inverse(align.cv2_matrices(self.lmk[k]))
        canvas = torch.from_numpy(self.pool[k]).to(self.dev)
        return align.warp(canvas, inv), inv

    def reference_answers(self, precision="fp32"):
        ref = self.reference(precision)
        self.ref_crops, pixels = {}, []
        out = {}
        for k in range(self.pool_n):
            crops, inv = self.reference_crops(k)
            if precision == "int8":
                crops = quant_act(crops, crops.abs().amax() / 127.0, 8)
            self.ref_crops[k] = crops
            if self.run.traced:
                pixels.append(warp_footprint_pixels(torch.from_numpy(inv).to(self.dev),
                                                    self.traffic["canvas"]))
            x = (crops.flip(-1) / 127.5 - 1.0).float()
            with tf32(False):
                out[k] = ref.embed(x)
        if pixels:
            self.run.info["warp_src_pixels"] = float(np.mean(pixels))
        return out

    def controls(self):
        want = self.reference_answers()
        want_crops = self.ref_crops
        got = self.reference_answers(self.spec.workload["control"])
        numbers = self.compare({k: [v] for k, v in got.items()}, want)[0]
        numbers["crop_gap"] = max(self.compare_crops([self.ref_crops[k] for k in
                                                      range(self.pool_n)], want_crops))
        return {"control": numbers}

    def compare_crops(self, crops, want):
        return [float((c.to(self.dev).double() - want[k]).abs().max())
                for k, c in enumerate(crops)]

    def check(self):
        numbers, rows = self.compare(self.answers, self.reference_answers())
        crop_gaps = self.compare_crops(self.crops, self.ref_crops)
        numbers["crop_gap"] = max(crop_gaps)
        lim = self.spec.workload["limits"]
        failed = sum(raw > lim["raw_gap"] or rect > lim["rect_gap"] for _, _, raw, rect in rows)
        failed += sum(g > lim["crop_gap"] for g in crop_gaps)
        return numbers, failed
