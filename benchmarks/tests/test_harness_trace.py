"""The trace reduction on a hand-made trace: busy time as the union of
device intervals, kernel groups, the move of a range's kernels to its
group, host spans and idle gaps named by the innermost open span."""

from types import SimpleNamespace

import pytest
import torch

from benchmarks import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Range(SimpleNamespace):
    def elapsed_us(self):
        return self.end - self.start


def ev(name, dev, start, end, parent=None, kernels=()):
    return SimpleNamespace(name=name, device_type=dev, time_range=Range(start=start, end=end),
                           cpu_parent=parent, kernels=list(kernels))


def fake_trace():
    window = ev("window", CPU, 0, 100)
    call = ev("embed call", CPU, 0, 60, window)
    quant = ev("quantize", CPU, 10, 20, call)
    div = ev("aten::div", CPU, 11, 12, quant,
             [SimpleNamespace(name="vectorized_elementwise_kernel", duration=5)])
    fetch = ev("fetch", CPU, 60, 100, window)
    device = [ev("vectorized_elementwise_kernel", CUDA, 10, 15),
              ev("se_gate_cluster_kernel<float>", CUDA, 20, 30),
              ev("se_gate_cluster_kernel<float>", CUDA, 25, 32),
              ev("Memcpy DtoH (Device -> Pageable)", CUDA, 70, 80),
              ev("quantize", CUDA, 10, 20),  # a range's device-side mirror: no operation
              ev("Optimizer.step#Adam.step", CUDA, 30, 90)]
    device[-1].is_user_annotation = True
    return SimpleNamespace(events=lambda: [window, call, quant, div, fetch] + device)


def test_groups_and_ranges():
    assert trace.group_of("void int8_conv_kernel<1>") == "int8_conv"
    assert trace.group_of("cudnn::engines_precompiled::nchwToNhwcKernel") == \
        "layout (NCHW<->NHWC)"
    assert trace.group_of("sm90_xmma_fprop_implicit_gemm_bf16") == "conv (cuDNN)"
    assert trace.group_of("warp_band_kernel<float>") == "warp_affine_band"
    assert trace.merge([(5, 7), (0, 2), (1, 3)]) == [[0, 3], [5, 7]]


def test_reduce_fake_trace():
    prof = fake_trace()
    assert trace.busy_seconds(prof) == pytest.approx((5 + 12 + 10) / 1e6)
    data = trace.reduce_trace(prof, 2, calls=4, window_s=0.5, busy_s=0.25)
    assert data.group_us["int8 quantize"] == 5 and data.group_us["elementwise"] == 0
    assert data.group_us["se_gating"] == 17 and data.group_us["copy / pad / cat"] == 10
    assert data.per_call_ms("se_gating") == pytest.approx(17 / 2 / 1e3)
    assert data.per_call_ms("int8_conv") is None
    assert data.gaps_by_span == {"embed call": 10 + 38, "quantize": 5, "fetch": 20}
    assert data.ranges_us["quantize"] == [(10, 20)]
    data.untraced_call_s = 0.25
    assert data.busy_share() == pytest.approx(0.25 / 4 / 0.25)
    b = data.breakdown()
    assert b["device_ops"][0] == ["se_gate_cluster_kernel<float>", 17 / 1e6]
    assert b["idle_gaps"][0] == ["embed call", 48 / 1e6]
