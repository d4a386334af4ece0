"""A cell's spec cut to a size the CPU runs in seconds (2 faces or pairs a
call, a pool of 2), for the harness's CPU tests only."""

from benchmarks import harness


def tiny_spec(cell: str) -> harness.Spec:
    spec = harness.load_spec(cell)
    spec.traffic.update(batch=2, pool=2, trace_calls=2, attribution_calls=2)
    if spec.kind == "train":
        spec.traffic.update(warm_steps=4)
    if "int8" in spec.config:
        spec.config["int8"]["calibration_faces"] = 2
    return spec


def run_tiny(cell: str, seed: int = 11, seconds: float = 0.3, trace: bool = False):
    """(result, checks) of a CPU run of `cell` at the tiny size."""
    run = harness.Run(tiny_spec(cell), seed, seconds, trace)
    return harness.execute(run, device_override="cpu")
