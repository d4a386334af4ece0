"""One run of one cell of the benchmark of `ffrnet_torch` on NVIDIA cards.

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits 2 without a result when there is no
card (or fewer than the cell asks for), and 3 when JAX or the JAX package
was loaded. Standard error ends with each correctness number beside its
limit; the last line of standard output is the result:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"], "checks"}.
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics from a torch.profiler trace of the window.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmarks import harness

    harness.prepare_environment()
    age_then, then = harness.process_age_s(), time.perf_counter()

    def age():
        return age_then + time.perf_counter() - then

    run = harness.Run(harness.load_spec(args.workload), args.seed, args.seconds,
                      bool(args.trace))
    try:
        result, checks = harness.execute(run, age=age)
        harness.import_guard()
    except harness.NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except harness.ForbiddenImport as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    dev = result["device"]
    print(f"[benchmark] {args.workload} seed {args.seed}: {dev['kind']} x{dev['count']}, "
          f"power limit {dev.get('power_limit')}; set-up {run.setup_s:.3f} s "
          f"{run.setup_parts}; {run.window.calls} calls in {run.window.seconds:.3f} s",
          file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value:.6g} limit {limit:.6g} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
