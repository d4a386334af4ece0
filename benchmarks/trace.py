"""Reduce the torch.profiler traces of a traced run to what the per-layer
readers read.

Kernel names are sorted into groups by `GROUPS` (a copy of
`ffrnet_torch/tools/profile_embed.py`'s, with the hand-written kernels'
names first); the device's busy time is the union of every device
operation's interval (kernels, copies, sets) in the device-only window.
In the attribution window, the kernels launched by an aten op that ran inside one of
the benchmark's own ranges listed in `RANGE_GROUPS` (a traced run opens
them around program functions: `quantize`, `align`) move from their
group to that range's group. Idle gaps are named by the innermost host
span that was open when the device went idle.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

# kernel-name patterns -> group; the first match wins. cuDNN's layout
# kernels go before the convolutions, and the convolutions before cuBLAS's
# GEMMs, whose names also hold "gemm"
GROUPS = (
    ("int8_conv", r"int8_conv_kernel"),
    ("se_gating", r"se_gate_cluster_kernel"),
    ("self_similarity", r"ss_gram_kernel"),
    ("channel_branch", r"cb_sigmoid_attention_kernel"),
    ("warp_affine_band", r"warp_band_kernel"),
    ("warp_affine_full", r"warp_full_kernel"),
    ("optimizer (foreach)", r"multi_tensor"),
    ("layout (NCHW<->NHWC)", r"nchwToNhwc|nhwcToNchw"),
    ("conv (cuDNN)", r"fprop|dgrad|wgrad|implicit|convolve|conv|winograd|fft|flip_filter|"
                     r"cudnn|gemm_cf32|cgemm"),
    ("gemm (cuBLAS)", r"gemm|gemv|cutlass|splitK"),
    ("reduce", r"reduce"),
    ("copy / pad / cat", r"copy|transpose|cat|pad|flip|memcpy|memset"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)
# the benchmark's ranges around program functions, whose kernels form a
# group of their own
RANGE_GROUPS = {"quantize": "int8 quantize", "align": "align"}
# the benchmark's host spans around its own calls
HOST_SPANS = ("window", "upload", "embed call", "fetch", "step", "align", "quantize")


def group_of(name: str) -> str:
    for group, pat in GROUPS:
        if re.search(pat, name, re.I):
            return group
    return "other"


def merge(intervals):
    """Sorted union of [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_operation(e, cuda) -> bool:
    """A device event that is an operation: not the device-side mirror of a
    host range (the benchmark's, or one a library opens, such as
    `Optimizer.step#Adam.step`)."""
    return (e.device_type == cuda and e.name not in HOST_SPANS
            and not getattr(e, "is_user_annotation", False))


def busy_seconds(prof) -> float:
    """Seconds in which some device operation ran: the union of the
    intervals of every device operation of a trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if device_operation(e, cuda)]
    if not spans:
        raise RuntimeError("trace: no device operation ran in the window")
    return sum(e - s for s, e in merge(spans)) / 1e6


@dataclass
class TraceData:
    """calls, window_s, busy_s: the device-only traced window; group_us,
    op_us, gaps_by_span, ranges_us: the attribution window of
    `group_calls` calls; untraced_call_s: the untraced window's wall
    seconds per call."""
    calls: int
    window_s: float
    busy_s: float
    group_calls: int
    group_us: dict
    op_us: dict
    gaps_by_span: dict
    ranges_us: dict = field(default_factory=dict)
    untraced_call_s: float = 0.0

    def busy_share(self) -> float:
        """The device's busy seconds per call of the device-only window over
        the wall seconds per call of the untraced one."""
        return self.busy_s / self.calls / self.untraced_call_s

    def per_call_ms(self, group: str):
        us = self.group_us.get(group)
        return None if us is None or self.group_calls == 0 else us / self.group_calls / 1e3

    def breakdown(self) -> dict:
        ops = sorted(self.op_us.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
                "idle_gaps": [[n, us / 1e6] for n, us in gaps]}


def _under(op, names):
    while op is not None:
        if op.name in names:
            return op.name
        op = op.cpu_parent
    return None


def reduce_trace(prof, group_calls: int, *, calls: int, window_s: float,
                 busy_s: float) -> TraceData:
    """The attribution window's trace `prof` (host ops and ranges too) of
    `group_calls` calls, with the device-only window's calls, seconds and
    busy seconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    windows = [e for e in events if e.name == "window" and e.device_type != cuda]
    if not windows:
        raise RuntimeError("trace: the benchmark's window range is missing")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    dev = [e for e in events if device_operation(e, cuda)
           and e.time_range.end > w0 and e.time_range.start < w1]
    if not dev:
        raise RuntimeError("trace: no device operation ran in the window")
    group_us, op_us = {}, {}
    for e in dev:
        us = e.time_range.elapsed_us()
        g = group_of(e.name)
        group_us[g] = group_us.get(g, 0.0) + us
        op_us[e.name] = op_us.get(e.name, 0.0) + us
    for op in events:
        if op.device_type != cuda and op.kernels and op.name.startswith("aten::"):
            rng = _under(op, RANGE_GROUPS)
            if rng is None:
                continue
            for k in op.kernels:
                for key, d in ((group_of(k.name), -k.duration), (RANGE_GROUPS[rng], k.duration)):
                    group_us[key] = group_us.get(key, 0.0) + d
    busy = merge((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev)

    host = [e for e in events if e.device_type != cuda and e.name in HOST_SPANS]
    ranges_us = {}
    for e in host:
        ranges_us.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    gaps = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        open_spans = [h for h in host if h.time_range.start <= s < h.time_range.end]
        inner = max(open_spans, key=lambda h: (h.time_range.start, -h.time_range.end),
                    default=None)
        name = "none" if inner is None else inner.name
        gaps[name] = gaps.get(name, 0.0) + (e - s)
    return TraceData(calls, window_s, busy_s, group_calls, group_us, op_us, gaps,
                     ranges_us)
