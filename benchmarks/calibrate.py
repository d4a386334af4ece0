"""Readings that the cells' correctness limits are set from (run on the
card; the benchmark's own runs never run it).

    python3 -m benchmarks.calibrate --workload <cell> --seeds 1,2,3 \
        [--control_seeds 1,2,3] [--calls 16]

For each seed, in one process: the cell's set-up and a short window of
`--calls` calls at the cell's own sizes, then the comparison a run makes
(the sound reading); for each control seed also the readings of the
cell's control (the reference in the program's place at the workload's
`control` precision) and, for a training cell, of its faults. One JSON
line a seed; the limits and the readings they were set from are in
PERF.md.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--calls", type=int, default=16)
    args = ap.parse_args(argv)
    from benchmarks import harness

    harness.prepare_environment()
    import torch

    spec = harness.load_spec(args.workload)
    info = harness.card_info(spec.chips)
    from ffrnet_torch.ops.kernels import _build

    _build.build_all()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(spec, seed, 1e9, False, device=torch.device("cuda", 0),
                          spans=harness.Spans(False))
        driver = harness.driver_class(spec.kind)(run)
        harness.run_window(run, driver, max_calls=args.calls)
        driver.after_window()
        driver.release()
        torch.cuda.empty_cache()
        sound, failed = driver.check()
        rec = {"seed": seed, "calls": run.window.calls, "sound": sound}
        if seed in controls:
            rec.update(driver.controls())
        print(json.dumps(rec), flush=True)
        del driver
        torch.cuda.empty_cache()
    print(json.dumps({"device": info}), flush=True)
    harness.import_guard()
    return 0


if __name__ == "__main__":
    sys.exit(main())
