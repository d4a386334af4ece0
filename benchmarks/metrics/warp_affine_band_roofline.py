"""warp_affine_band_roofline: the band warp's bound per call from the
source pixels its transforms need (`bounds.warp_band_bound` on the pool's
mean footprint, float32 canvases) over its device time per call, in %."""

from benchmarks.bounds import warp_band_bound


def read(run, name):
    t = run.trace.per_call_ms("warp_affine_band")
    if not t:
        return None
    return 100.0 * warp_band_bound(run.info["warp_src_pixels"], run.info["batch"])[0] / t
