"""int8 x int8 -> int32 convolution with a fused dequantizing epilogue: CUDA
kernel (csrc/int8_conv.cu), the operand layout it takes, its plan, and the
plain twin.

Replaces XLA's int8 convolution and dot in ffrnet_tpu/ops/quant.py:143 and
:169 (no Pallas original). The kernel computes

    out[n, o, ho, wo] = fp32(acc) * deq[o]  (+ bias[o]),  cast to out_dtype,
    acc = sum over (r, s, c) of x[n, ho*stride - pad + r, wo*stride - pad + s, c]
                                * w[o, r, s, c]   in int32,

with x zero outside the map. Operands: `to_nhwc` gives the int8 activation
as (N, H, W, Cp), and `pack_weight` the int8 weight as (Coutp, KH, KW, Cp),
Cp and Coutp rounded up to multiples of 64 with zeros, which add exactly 0.
A Linear is the same product over a (N, 1, 1, K) map with a 1x1 window.

`_int8_plan` sizes each call: the tile's columns (64, 128 or 256), the ring's
stages, and either persistent CTAs (one per SM, walking tiles) or, when the
tiles fill less than one wave, K split over a thread-block cluster;
`_int8_schedule` lists the (CTA, tile, K range) work the kernel then does.

The plain twin computes the same integer product exactly (float64 on the
tensor's device: |acc| <= 127^2 * 25088 < 2^53) and then the epilogue's two
fp32 roundings, so kernel and twin agree to the bit.

The wrapper calls the operator `ffrnet::int8_conv` (`_ops.py`): the kernel
for CUDA tensors, the plain twin for CPU ones, chosen by PyTorch's
dispatcher; each implementation checks its operands first (`_check`). It
serves inference only and has no gradient.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ffrnet_torch.ops.kernels import _build
from ffrnet_torch.ops.kernels._ops import define

# the packed operands' padding: channels to a multiple of 64 (a stage's 64
# or 128 bytes, the tensor maps' 16-byte strides), output channels to the
# narrowest tile
K_ALIGN = 64
N_ALIGN = 64
_OUT_DTYPES = (torch.float32, torch.bfloat16)

# mirrors of int8_conv.cu: tile rows, the ring's bytes and most stages, the
# largest cluster, the epilogue's staging (CHUNK columns at a pitch of SPITCH
# int32), one CTA an SM, and the shared memory a CTA may take on an H100
BM = 128
RING_BYTES, MAX_STAGES = 196_608, 16
MAX_CLUSTER = 8
_CHUNK, _SPITCH = 32, 68
CTAS_PER_SM = 1
SMEM_LIMIT = 232_448


class Int8Plan(NamedTuple):
    bm: int
    bn: int
    bk: int
    stages: int
    cluster: int   # CTAs a tile: 1 = persistent CTAs, else split-K in a cluster
    kstages: int   # K stages of the whole product, KH KW ceil(Cp / BK)
    m_tiles: int
    n_tiles: int
    tiles: int
    grid: int
    smem: int


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, KH, KW) or Linear (Cout, K) int8 -> (Coutp, KH, KW, Cinp)
    int8, channels last, zero rows and channels appended."""
    if wq.ndim == 2:
        wq = wq[:, :, None, None]
    cout, cin, kh, kw = wq.shape
    out = torch.zeros((_round_up(cout, N_ALIGN), kh, kw, _round_up(cin, K_ALIGN)),
                      dtype=torch.int8, device=wq.device)
    out[:cout, :, :, :cin] = wq.permute(0, 2, 3, 1)
    return out


def to_nhwc(xq: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) or (N, K) int8 -> contiguous (N, H, W, Cp) int8 with
    zero channels appended up to Cp, a multiple of 64."""
    if xq.ndim == 2:
        return F.pad(xq, (0, _round_up(xq.shape[1], K_ALIGN) - xq.shape[1]))[:, None, None, :]
    x = xq.permute(0, 2, 3, 1)
    c = x.shape[-1]
    if c % K_ALIGN:
        x = F.pad(x, (0, _round_up(c, K_ALIGN) - c))
    return x.contiguous()


def _out_hw(h, w, kh, kw, stride, padding):
    return (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1


def _stage_bk(cp: int) -> int:
    """K bytes a stage: 64 (the 64-byte swizzle) where Cp is 64, else 128."""
    return 64 if cp == 64 else 128


def _stages(bn: int, bk: int) -> int:
    """int8_conv.cu's Cfg<BN, BK>::STAGES: as many as 192 KB holds, at most 16."""
    return min(MAX_STAGES, RING_BYTES // ((BM + bn) * bk))


def _smem_bytes(bn: int, bk: int) -> int:
    """int8_conv.cu's Cfg<BN, BK>::BYTES: the ring's A (BM x BK) and B (BN x
    BK) stages, both consumer warpgroups' epilogue staging and deq/bias,
    the full and empty barriers, and 1 KB to align the ring to the
    swizzle's 1024-byte atoms."""
    stages = _stages(bn, bk)
    return stages * (BM + bn) * bk + 2 * _CHUNK * _SPITCH * 4 + 16 * bn + 16 * stages + 1024


@functools.lru_cache(maxsize=4096)
def _int8_plan(n, h, w, cp, coutp, kh, kw, stride, padding, out_dtype, sms) -> Int8Plan:
    """The kernel's plan for one call: the tile width BN (64, 128 or 256, a
    divisor of Coutp), the stage width BK, the ring, and the grid. With at least one tile per
    SM the CTAs are persistent (grid = SMs) and take all of K; with fewer,
    K is split over a cluster of 2, 4 or 8 CTAs (at most one per K stage,
    and tiles x cluster at most the SMs) and the grid is tiles x cluster.
    (An H100 holds 15 clusters of 8 at once, not 16: the Linear's 16 tiles
    at N=256 still run faster split 8 ways than 4.) BN is the one with
    the least work for the busiest CTA (tiles per CTA x BN x K stages per
    CTA); on a tie the wider tile, which reads each A row fewer times.
    The output type takes no part in the choice (the epilogue stages both
    types the same way)."""
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_conv: out_dtype float32 or bfloat16, got {out_dtype}")
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    m_tiles = -(-n * ho * wo // BM)
    bk = _stage_bk(cp)
    kstages = kh * kw * -(-cp // bk)
    best = None
    for bn in (256, 128, 64):
        if coutp % bn:
            continue
        tiles = m_tiles * (coutp // bn)
        if tiles >= sms:
            cluster, grid, cost = 1, sms, -(-tiles // sms) * bn * kstages
        else:
            cluster = 1
            while (2 * cluster <= MAX_CLUSTER and 2 * cluster <= kstages
                   and 2 * cluster * tiles <= sms):
                cluster *= 2
            grid, cost = tiles * cluster, bn * -(-kstages // cluster)
        if best is None or cost < best[0]:
            best = (cost, Int8Plan(BM, bn, bk, _stages(bn, bk), cluster, kstages, m_tiles,
                                   coutp // bn, tiles, grid, _smem_bytes(bn, bk)))
    if best is None:
        raise ValueError(f"int8_conv: Coutp {coutp} is not a multiple of 64")
    return best[1]


def _int8_schedule(plan: Int8Plan):
    """(cta, tile, k_begin, k_count) for every tile each CTA of the plan
    takes, in int8_conv.cu's order: persistent CTA b takes tiles b, b +
    grid, ...; in a cluster, CTA b takes tile b // cluster and K stages
    split by its rank b % cluster, the first kstages % cluster ranks one
    stage more. Tile t is row tile t // n_tiles, column tile t % n_tiles."""
    out = []
    if plan.cluster == 1:
        for b in range(plan.grid):
            out.extend((b, t, 0, plan.kstages) for t in range(b, plan.tiles, plan.grid))
        return out
    base, rem = divmod(plan.kstages, plan.cluster)
    for b in range(plan.grid):
        r = b % plan.cluster
        out.append((b, b // plan.cluster, r * base + min(r, rem), base + (r < rem)))
    return out


def _check(xq, wp, deq, bias, stride, padding, out_dtype):
    if xq.dtype != torch.int8 or wp.dtype != torch.int8:
        raise TypeError(f"int8_conv: int8 operands, got {xq.dtype} and {wp.dtype}")
    if xq.ndim != 4 or wp.ndim != 4 or xq.shape[3] != wp.shape[3]:
        raise ValueError(f"int8_conv: x (N, H, W, Cp) and w (Coutp, KH, KW, Cp), got "
                         f"{tuple(xq.shape)} and {tuple(wp.shape)}")
    if xq.shape[3] % K_ALIGN or wp.shape[0] % N_ALIGN:
        raise ValueError(f"int8_conv: Cp % {K_ALIGN} and Coutp % {N_ALIGN} must be 0, got "
                         f"{xq.shape[3]} and {wp.shape[0]} (to_nhwc / pack_weight pad them)")
    if deq.dtype != torch.float32 or deq.ndim != 1 or not 0 < deq.shape[0] <= wp.shape[0]:
        raise ValueError(f"int8_conv: deq fp32 (Cout,) with Cout <= {wp.shape[0]}, got "
                         f"{deq.dtype} {tuple(deq.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != tuple(deq.shape)):
        raise ValueError(f"int8_conv: bias fp32 {tuple(deq.shape)}, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_conv: out_dtype float32 or bfloat16, got {out_dtype}")
    # the im2col tensor map takes strides up to 8 and window corners in
    # [-128, 127]
    if (not 1 <= stride <= 8 or not 0 <= padding <= 127
            or max(wp.shape[1], wp.shape[2]) - 1 - padding > 128
            or min(_out_hw(xq.shape[1], xq.shape[2], wp.shape[1], wp.shape[2], stride,
                           padding)) < 1):
        raise ValueError(f"int8_conv: stride {stride}, padding {padding} on "
                         f"{tuple(xq.shape)} with a {wp.shape[1]}x{wp.shape[2]} window")
    devs = {t.device for t in (xq, wp, deq) + ((bias,) if bias is not None else ())}
    if len(devs) != 1:
        raise ValueError(f"int8_conv: operands on several devices {devs}")


def int8_conv_plain(xq, wp, deq, bias=None, *, stride=1, padding=0, out_dtype=torch.float32):
    """The kernel's function as PyTorch ops: the integer product in float64
    (exact) on the tensors' device, then fp32(acc) * deq, then + bias, each
    rounded to fp32, then the cast."""
    n, h, w, _ = xq.shape
    _, kh, kw, _ = wp.shape
    cout = deq.shape[0]
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    cols = F.unfold(xq.permute(0, 3, 1, 2).double(), (kh, kw), padding=padding,
                    stride=stride)                                # (N, Cp KH KW, L), (c, r, s)
    wmat = wp[:cout].permute(0, 3, 1, 2).reshape(cout, -1).double()
    acc = torch.matmul(wmat, cols).reshape(n, cout, ho, wo)      # exact integers
    y = acc.float() * deq.reshape(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y.to(out_dtype)


def int8_conv(xq, wp, deq, bias=None, *, stride=1, padding=0, out_dtype=torch.float32):
    """(N, H, W, Cp) int8 x (Coutp, KH, KW, Cp) int8 -> (N, Cout, Ho, Wo) in
    out_dtype, Cout = len(deq): the plain version on the CPU, the kernel on
    a CUDA tensor."""
    return _OP(xq, wp, deq, bias, stride, padding, out_dtype)


def _cpu(xq, wp, deq, bias, stride, padding, out_dtype):
    _check(xq, wp, deq, bias, stride, padding, out_dtype)
    return int8_conv_plain(xq, wp, deq, bias, stride=stride, padding=padding,
                           out_dtype=out_dtype)


def _fake(xq, wp, deq, bias, stride, padding, out_dtype):
    _check(xq, wp, deq, bias, stride, padding, out_dtype)
    ho, wo = _out_hw(xq.shape[1], xq.shape[2], wp.shape[1], wp.shape[2], stride, padding)
    return xq.new_empty((xq.shape[0], deq.shape[0], ho, wo), dtype=out_dtype)


def _aligned(t):
    """Contiguous, and 16-byte aligned for the kernel's 16-byte copies and
    the weights' tensor map."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(xq, wp, deq, bias, stride, padding, out_dtype):
    _check(xq, wp, deq, bias, stride, padding, out_dtype)
    n, h, w, cp = xq.shape
    coutp, kh, kw, _ = wp.shape
    cout = deq.shape[0]
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    xq, wp, deq = _aligned(xq), _aligned(wp), deq.contiguous()
    bias = None if bias is None else bias.contiguous()
    stream = _build.stream_handle(xq.device)
    plan = _int8_plan(n, h, w, cp, coutp, kh, kw, stride, padding, out_dtype, _sms(xq.device))
    out = torch.empty((n, cout, ho, wo), device=xq.device, dtype=out_dtype)
    fn = _build.load("int8_conv", "int8_conv_launch", 5, 19)
    rc = fn(xq.data_ptr(), wp.data_ptr(), deq.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), n, h, w, cp, cout,
            coutp, kh, kw, stride, padding, ho, wo, int(out_dtype == torch.bfloat16), plan.bn,
            plan.bk, plan.stages, plan.cluster, plan.grid, plan.smem, stream)
    _build.check_launch("int8_conv", rc)
    int8_conv.launches += 1
    return out


_OP = define("int8_conv(Tensor xq, Tensor wp, Tensor deq, Tensor? bias, int stride, "
             "int padding, ScalarType out_dtype) -> Tensor", cpu=_cpu, cuda=_launch, fake=_fake)
int8_conv.launches = 0
