"""The benchmark's machinery, driven by data.

A cell is found by name: `BENCHMARK.json` (the checkout's root) names its
configuration, its traffic and the metrics it reports; the cell's file
`benchmarks/workloads/<cell>.json` gives the limits of its correctness
numbers; `benchmarks/configs/<config>.json` the model; the traffic's file
`benchmarks/traffic/<traffic>.json` its kind and parameters, and the kind's
driver is `benchmarks/traffic/<kind>.py`. Each metric is read by
`benchmarks/metrics/<metric>.py`, or by the family's
`benchmarks/metrics/<name before the first dot>.py`. A new cell,
configuration, traffic mix or metric is new files and new entries of
`BENCHMARK.json`; nothing here names one.

A run (`execute`): the kernels are built or found, the driver sets the
cell up from the seed and warms up its shapes (set-up ends on a
synchronize), the window runs the driver's calls for `seconds` (a traced
run: `trace_calls` calls untraced, as many with the device traced, then
`attribution_calls` with the host too, `traced_window`), the driver
keeps what its check needs of the state the window left
(`after_window`), then the peak memory is read, the program's state is
freed, and the driver compares what the window produced with the plain
reference.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ffrnet_tpu")
# fixed cache directories inside the checkout; the program's nvcc build
# directory is ffrnet_torch/_build/, also inside it
CACHE = HERE / "_cache"
CACHE_ENV = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
             "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}


class NoDevice(RuntimeError):
    """No card, or fewer cards than the cell asks for."""


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package is loaded in the run's process."""


def process_age_s() -> float:
    """Seconds since this process started (10 ms resolution), from /proc."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def prepare_environment() -> None:
    """Cache directories at fixed paths inside the checkout, and no JAX
    behind any library's back. Before torch is imported."""
    for var, sub in CACHE_ENV.items():
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Spec:
    """Everything the data says about one cell."""
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(cell: str, root: Path = ROOT) -> Spec:
    bench = _load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"benchmark: no workload {cell!r} in BENCHMARK.json")
    workload = _load_json(HERE / "workloads" / f"{cell}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise SystemExit(f"benchmark: {cell}: {key} {workload[key]!r} in its workload "
                             f"file, {entry[key]!r} in BENCHMARK.json")
    config = _load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = _load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    return Spec(cell, entry["chips"], config, traffic, workload,
                [m for m in bench["end_to_end"] if _reports(m, cell)],
                [m for m in bench["per_layer"] if _reports(m, cell)])


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of `metric`: metrics/<metric>.py, else the family's
    metrics/<prefix>.py."""
    for stem in (metric, metric.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path, f"benchmarks_metric_{stem.replace('.', '_')}")
    raise SystemExit(f"benchmark: no reader for metric {metric!r} under benchmarks/metrics/")


def driver_class(kind: str):
    path = HERE / "traffic" / f"{kind}.py"
    if not path.exists():
        raise SystemExit(f"benchmark: no driver for traffic kind {kind!r}")
    return load_module(path, f"benchmarks_traffic_{kind}").Driver


# ----------------------------------------------------------------- device


def card_info(chips: int) -> dict:
    """The device block of the result; raises NoDevice without enough cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: this benchmark runs on a card")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, {torch.cuda.device_count()} visible")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
        info["power_limit"] = out[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "unknown (nvidia-smi failed)"
    return info


def import_guard() -> None:
    found = sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if found:
        raise ForbiddenImport(f"the run loaded {', '.join(found)}")


# ------------------------------------------------------------------ spans


class Spans:
    """Host spans of the benchmark's own calls into the program: profiler
    ranges in a traced run, nothing otherwise."""

    def __init__(self, traced: bool):
        self.traced = traced

    def __call__(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


# ----------------------------------------------------------------- run


@dataclass
class Window:
    calls: int = 0
    items: int = 0
    seconds: float = 0.0
    latencies_s: list = field(default_factory=list)


@dataclass
class Run:
    """One run of one cell: what the readers read."""
    spec: Spec
    seed: int
    seconds: float
    traced: bool
    device: object = None
    setup_s: float = 0.0
    setup_parts: dict = field(default_factory=dict)
    window: Window = field(default_factory=Window)
    trace: object = None
    info: dict = field(default_factory=dict)
    spans: Spans = None


def run_window(run: Run, driver, max_calls=None, window: Window = None) -> Window:
    """Call the driver until `run.seconds` have passed (or `max_calls`
    calls), then close on its synchronize."""
    w = run.window if window is None else window
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        w.items += driver.call(w.calls)
        t1 = time.perf_counter()
        w.latencies_s.append(t1 - t0)
        w.calls += 1
        if t1 - start >= run.seconds or (max_calls is not None and w.calls >= max_calls):
            break
    driver.finish()
    w.seconds = time.perf_counter() - start
    return w


def traced_window(run: Run, driver):
    """Three windows of the same calls. The first is not traced: its wall
    time per call is what the device's busy time is set against. The second
    records the device alone (CUDA activity: each kernel's, copy's and set's
    interval): its busy seconds, and its own window seconds for the result's
    `device` block. The profiler slows the host's launches (a train step:
    85 ms untraced, 150 ms traced on an H100), so a share of a traced
    window's wall time would count the profiler's cost as idle. The third
    also records the host's ops and the benchmark's ranges: kernel time by
    group and by range, host spans, idle gaps by span (its host runs slower
    still; its kernels do not)."""
    import torch

    from benchmarks.trace import busy_seconds, reduce_trace

    tr = run.spec.traffic
    untraced = run_window(run, driver, max_calls=tr["trace_calls"], window=Window())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_window(run, driver, max_calls=tr["trace_calls"])
    busy_s = busy_seconds(prof)
    second = Window()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with driver.instrumented(), torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("window"):
            run_window(run, driver, max_calls=tr["attribution_calls"], window=second)
    run.trace = reduce_trace(prof, second.calls, calls=run.window.calls,
                             window_s=run.window.seconds, busy_s=busy_s)
    run.trace.untraced_call_s = untraced.seconds / untraced.calls


def execute(run: Run, age=None, device_override=None):
    """Run the cell; returns (result dict, [(check, value, limit)]).
    `device_override` (tests): run on that device without looking for a
    card and without building the kernels."""
    import torch

    spec = run.spec
    if device_override is None:
        dev_info = card_info(spec.chips)
        run.device = torch.device("cuda", 0)
        from ffrnet_torch.ops.kernels import _build

        run.setup_parts["build_s"] = _build.build_all()
    else:
        dev_info = {"platform": torch.device(device_override).type, "kind": "test",
                    "count": 1}
        run.device = torch.device(device_override)
    run.spans = Spans(run.traced)
    t_set = time.perf_counter()
    driver = driver_class(spec.kind)(run)
    sync(run.device)
    run.setup_parts["driver_s"] = time.perf_counter() - t_set
    run.setup_s = age() if age is not None else time.perf_counter() - t_set

    if run.traced:
        traced_window(run, driver)
    else:
        run_window(run, driver)
    driver.after_window()
    if run.device.type == "cuda":
        dev_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(run.device)
    driver.release()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    numbers, failed = driver.check()
    limits = spec.workload["limits"]
    checks = [(k, numbers[k], limits[k]) for k in limits]
    correct = all(v == v and v <= lim for _, v, lim in checks)

    names = spec.per_layer if run.traced else spec.end_to_end
    metrics = {}
    for m in names:
        value = reader(m["name"]).read(run, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if run.traced:
        dev_info["busy_s"] = run.trace.busy_s
        dev_info["window_s"] = run.trace.window_s
    result = {"correct": bool(correct), "attempted": run.window.calls, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if run.traced:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, inclusive; one value is
    its own)."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=100, method="inclusive")[94]
