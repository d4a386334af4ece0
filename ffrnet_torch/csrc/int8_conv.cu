// int8 x int8 -> int32 convolution on the tensor cores, with the
// dequantizing epilogue fused: out = float(acc) * deq[o] (+ bias[o]).
//
// Replaces ffrnet_tpu/ops/quant.py:143 (conv2d_int8: XLA's
// lax.conv_general_dilated on int8 operands with
// preferred_element_type=int32) and :169 (linear_int8: XLA's
// lax.dot_general on the same operands). The JAX package leaves both
// products to XLA; there is no Pallas original. PyTorch has no call that
// computes this product on a CUDA tensor (F.conv2d takes no integer types).
//
// Operands, as ffrnet_torch/ops/kernels/int8_conv.py prepares them:
//   x    (N, H, W, Cp) int8, NHWC, Cp a multiple of 64 (zero channels
//        appended to C). The activation is quantized in NCHW and then
//        transposed as int8, a quarter of the fp32 bytes, so that one
//        window tap's 64 channels are 64 contiguous bytes: four 16-byte
//        copies per row of the A tile.
//   w    (Coutp, KH, KW, Cp) int8, Coutp a multiple of 64 (zero rows and
//        channels appended); packed once, when the site is quantized.
//   deq  (Cout,) fp32: s_x * s_w[o]; bias (Cout,) fp32 or null.
//   out  (N, Cout, Ho, Wo), fp32 or bf16 (NCHW, the port's layout).
// A Linear (K = 25088 for the encoder's output layer) is the same kernel
// as a 1x1 convolution over a 1x1 map with Cp = K.
//
// Implicit GEMM: rows m = (n, ho, wo) of the output, columns o, depth
// k = (r, s, c) in the packed weight's order. A CTA of 4 warps computes a
// 128 x 64 tile; each warp 64 x 32 with mma.sync m16n8k32 s8.s8.s32. The
// K loop walks one 64-channel block of one window tap per step, through a
// 3-stage cp.async ring in shared memory; the loader zero-fills taps that
// fall in the zero padding or rows beyond M (cp.async with source size 0),
// so padding and stride cost no branches in the product. Zero channels
// added to K contribute exactly 0. |acc| <= 127 * 127 * 25088 = 4.05e8 <
// 2^31, so the int32 sum never wraps.
//
// The epilogue multiplies and adds with __fmul_rn / __fadd_rn, never
// contracted into an FMA, so it rounds as the plain twin does (two fp32
// roundings) and the two agree to the bit on the same int8 inputs.
//
// Bound on an H100 SXM: operations, 2 N Ho Wo Cout KH KW C at 1,979 TOP/s
// (int8 dense), or bytes: the int8 input and weights read once and the
// output written once at 3.35 TB/s. Later work: wgmma and TMA, and the
// quantize fused into the loader (it is plain PyTorch now).
#include "common.cuh"

namespace {

constexpr int BM = 128;      // output rows (pixels) per CTA
constexpr int BN = 64;       // output channels per CTA
constexpr int BK = 64;       // K bytes per stage: one 64-channel block of one tap
constexpr int STAGES = 3;
constexpr int THREADS = 128;
// shared row pitch: 80 bytes = 20 words, so the 8 rows of a fragment load
// (lanes 4g..4g+3 read row g) fall in 32 distinct banks; a multiple of 16
// for cp.async
constexpr int PITCH = BK + 16;

struct ConvShape {
  int n, h, w, cp, cout, kh, kw, stride, pad, ho, wo;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (source size 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x32, row) * b (32x8, col), int8 in, int32 accumulate
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                     const float* __restrict__ deq, const float* __restrict__ bias,
                     OutT* __restrict__ out, ConvShape s) {
  __shared__ __align__(16) int8_t As[STAGES][BM][PITCH];
  __shared__ __align__(16) int8_t Bs[STAGES][BN][PITCH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps of 64 x 32
  const int hw_out = s.ho * s.wo;
  const long long M = (long long)s.n * hw_out;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;

  // loader: 4 consecutive threads copy one 64-byte row, 16 bytes each;
  // this thread takes rows row0 + 32 i of A (i < 4) and of B (i < 2)
  const int part = tid & 3, row0 = tid >> 2;
  int a_n[4], a_h[4], a_w[4];  // sample (-1 beyond M), window's top-left input pixel
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + row0 + 32 * i;
    if (m < M) {
      const int n = (int)(m / hw_out);
      const int p = (int)(m - (long long)n * hw_out);
      const int ho = p / s.wo, wo = p - ho * s.wo;
      a_n[i] = n;
      a_h[i] = ho * s.stride - s.pad;
      a_w[i] = wo * s.stride - s.pad;
    } else {
      a_n[i] = -1;
      a_h[i] = a_w[i] = 0;
    }
  }
  const int kc = s.cp / BK;  // channel blocks per tap
  const int ktiles = s.kh * s.kw * kc;
  const long long wrow = (long long)s.kh * s.kw * s.cp;  // bytes per packed weight row

  auto load_tile = [&](int kt, int buf) {
    const int tap = kt / kc;
    const int c0 = (kt - tap * kc) * BK + part * 16;
    const int r = tap / s.kw, q = tap - r * s.kw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hi = a_h[i] + r, wi = a_w[i] + q;
      const bool ok = a_n[i] >= 0 && hi >= 0 && hi < s.h && wi >= 0 && wi < s.w;
      const int8_t* src =
          ok ? x + (((long long)a_n[i] * s.h + hi) * s.w + wi) * s.cp + c0 : x;
      cp_async16(&As[buf][row0 + 32 * i][part * 16], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = o0 + row0 + 32 * i;  // < Coutp: the packed weight has the rows
      cp_async16(&Bs[buf][row0 + 32 * i][part * 16],
                 wt + (long long)o * wrow + (long long)tap * s.cp + c0, true);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles) load_tile(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and tile kt-1's buffer is free
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_tile(next, next % STAGES);
    cp_async_commit();
    const int buf = kt % STAGES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* pa = &As[buf][wm * 64 + i * 16 + g][ks + t4 * 4];
        a[i][0] = lds32(pa);
        a[i][1] = lds32(pa + 8 * PITCH);
        a[i][2] = lds32(pa + 16);
        a[i][3] = lds32(pa + 8 * PITCH + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* pb = &Bs[buf][wn * 32 + j * 8 + g][ks + t4 * 4];
        b[j][0] = lds32(pb);
        b[j][1] = lds32(pb + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: c0, c1 at row g, c2, c3 at row g + 8; columns 2 t4, 2 t4 + 1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 64 + i * 16 + g + half * 8;
      if (m >= M) continue;
      const int n = (int)(m / hw_out);
      const int p = (int)(m - (long long)n * hw_out);
      OutT* orow = out + (long long)n * s.cout * hw_out + p;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn * 32 + j * 8 + t4 * 2 + e;
          if (o >= s.cout) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][half * 2 + e]), deq[o]);
          if (bias != nullptr) v = __fadd_rn(v, bias[o]);
          orow[(long long)o * hw_out] = ffr::from_f<OutT>(v);
        }
      }
    }
  }
}

}  // namespace

extern "C" int int8_conv_launch(const void* x, const void* w, const void* deq, const void* bias,
                                void* out, int n, int h, int wd, int cp, int cout, int coutp,
                                int kh, int kw, int stride, int pad, int ho, int wo,
                                int out_bf16, void* stream) {
  const ConvShape s{n, h, wd, cp, cout, kh, kw, stride, pad, ho, wo};
  const long long m = (long long)n * ho * wo;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)(coutp / BN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* dq = static_cast<const float*>(deq);
  const float* b = static_cast<const float*>(bias);
  if (out_bf16) {
    int8_conv_kernel<__nv_bfloat16>
        <<<grid, THREADS, 0, st>>>(xq, wq, dq, b, static_cast<__nv_bfloat16*>(out), s);
  } else {
    int8_conv_kernel<float><<<grid, THREADS, 0, st>>>(xq, wq, dq, b, static_cast<float*>(out), s);
  }
  return static_cast<int>(cudaGetLastError());
}
