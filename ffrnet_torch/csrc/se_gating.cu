// Squeeze-excitation gate of the IR-SE encoder, NCHW, fp32 or bf16.
//
// Replaces ffrnet_tpu/ops/pallas/se_gating.py::se_gating_pallas. Per sample:
//     pooled = mean_HW(x)                          (C)      fp32
//     g      = sigmoid(relu(pooled W1^T) W2^T)     (C)      fp32
//     out    = x * g                               g cast to x's type first
//
// Bound on the H100: bytes. The gate's two mat-vecs are 4*C*C/16 FLOP per
// sample, nothing beside the map itself: at N=256 one IR-SE50 forward moves
// 3.65 GB through its 24 gates in fp32 (x read once, out written once),
// 1.09 ms at 3.35 TB/s.
//
// Design: the Pallas kernel kept one whole sample in VMEM; here a sample's
// 56x56x64 map is 784 KB, far above a block's 227 KB of shared memory, and
// one block per sample would leave most of the 132 SMs idle at small N. So
// the gate is three launches; the two that move the map spread it over
// the card:
//   1. pool: one warp per (sample, channel) row; NCHW keeps the row's HW
//      values contiguous, so the warp's loads coalesce.
//   2. gate: one block per sample (N blocks, fewer than the 132 SMs below
//      N=132), both mat-vecs from shared memory; its work is 4*C*C/16
//      FLOP a sample and it reads no map.
//   3. scale: a grid-stride elementwise pass, four values per thread.
// x is read twice (pool, scale): 1.5x the bound's bytes where the map does
// not stay in the 50 MB L2 between the two passes.
#include "common.cuh"

namespace {

using ffr::from_f;
using ffr::to_f;

template <typename T>
__global__ void __launch_bounds__(256)
se_pool_kernel(const T* __restrict__ x, float* __restrict__ pooled, int rows, int hw) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const T* row = x + (size_t)warp * hw;
  float s = 0.f;
  for (int i = lane; i < hw; i += 32) s += to_f(row[i]);
  s = ffr::warp_sum(s);
  if (lane == 0) pooled[warp] = s / (float)hw;
}

template <typename T>
__global__ void __launch_bounds__(256)
se_gate_kernel(const float* __restrict__ pooled, const T* __restrict__ w1,
               const T* __restrict__ w2, float* __restrict__ gate, int c, int r) {
  extern __shared__ float sm[];  // c pooled values, then r hidden values
  float* p = sm;
  float* hid = sm + c;
  const int n = blockIdx.x;
  for (int i = threadIdx.x; i < c; i += blockDim.x) p[i] = pooled[(size_t)n * c + i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int j = warp; j < r; j += nwarps) {
    float s = 0.f;
    for (int i = lane; i < c; i += 32) s += p[i] * to_f(w1[(size_t)j * c + i]);
    s = ffr::warp_sum(s);
    if (lane == 0) hid[j] = fmaxf(s, 0.f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < r; ++j) s += hid[j] * to_f(w2[(size_t)i * r + j]);
    gate[(size_t)n * c + i] = ffr::sigmoid(s);
  }
}

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

// total % 4 == 0 and 4-value alignment are checked by the wrapper.
template <typename T>
__global__ void __launch_bounds__(256)
se_scale_kernel(const T* __restrict__ x, const float* __restrict__ gate, T* __restrict__ out,
                long long total, int hw) {
  const long long stride = (long long)gridDim.x * blockDim.x * 4;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4; i < total;
       i += stride) {
    Vec4<T> a = *reinterpret_cast<const Vec4<T>*>(x + i);
    Vec4<T> b;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float g = to_f(from_f<T>(gate[(i + k) / hw]));  // gate in x's type
      b.v[k] = from_f<T>(to_f(a.v[k]) * g);
    }
    *reinterpret_cast<Vec4<T>*>(out + i) = b;
  }
}

template <typename T>
void launch(const void* x, const void* w1, const void* w2, void* out, float* pooled,
            float* gate, int n, int c, int hw, int r, cudaStream_t stream) {
  const int rows = n * c;
  se_pool_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(static_cast<const T*>(x), pooled,
                                                        rows, hw);
  se_gate_kernel<T><<<n, 256, (c + r) * sizeof(float), stream>>>(
      pooled, static_cast<const T*>(w1), static_cast<const T*>(w2), gate, c, r);
  const long long total = (long long)rows * hw;
  long long blocks = (total / 4 + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  se_scale_kernel<T><<<(int)blocks, 256, 0, stream>>>(static_cast<const T*>(x), gate,
                                                      static_cast<T*>(out), total, hw);
}

}  // namespace

// x, out: (N, C, H*W) contiguous; w1: (R, C); w2: (C, R), all of one type
// (float if is_bf16 == 0, else bf16). pooled, gate: (N, C) fp32 scratch.
// Returns cudaGetLastError() after the launches.
extern "C" int se_gating_launch(const void* x, const void* w1, const void* w2, void* out,
                                void* pooled, void* gate, int n, int c, int hw, int r,
                                int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(pooled);
  float* g = static_cast<float*>(gate);
  if (is_bf16)
    launch<__nv_bfloat16>(x, w1, w2, out, p, g, n, c, hw, r, s);
  else
    launch<float>(x, w1, w2, out, p, g, n, c, hw, r, s);
  return (int)cudaGetLastError();
}
