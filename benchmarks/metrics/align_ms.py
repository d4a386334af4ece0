"""align_ms: the host's ms per call inside `FFRNet.align` (the cp2tform
solve, the canvas upload, the cast and the warp's launch), from the range a
traced run opens around `ffrnet_torch.api.align_faces`. The device's share
of it runs on after the range closes: `warp_affine_band_roofline`."""


def read(run, name):
    spans = run.trace.ranges_us.get("align")
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) / 1e3
