// Spatial and channel self-similarity of a feature map, fp32 or bf16 in,
// the same type out, fp32 inside.
//
// Replaces ffrnet_tpu/ops/pallas/self_similarity.py::self_similarity_pallas.
// X is one sample's (C, HW) channel-major map (NCHW without the copy):
//     ss_space[p,q]   = (X^T X)[p,q] * inv_r[p] * inv_r[q]   (HW, HW)
//     ss_channel[c,d] = (X X^T)[c,d] * inv_s[c] * inv_s[d]   (C, C)
//     inv = 1 / max(||row||, 1e-12), from the same X as the Gram.
//
// Bound on the H100: bytes. At C=512, HW=49 a sample moves 1.16 MB in fp32,
// of which writing ss_channel is 1 MB; both Grams are symmetric, so a SYRK
// needs 14 MFLOP of it. At N=256: 0.30 GB is 0.0885 ms at 3.35 TB/s, and
// 3.6 GFLOP is 0.054 ms at 67 TFLOP/s fp32 SIMT. This kernel computes the
// full Grams (28 MFLOP a sample), which still fits under the bytes' time if
// many small blocks keep the SIMT units and the memory busy together.
//
// Design: ss_channel is tiled into 64x64 output tiles, one block each
// (grid (C/64)^2 x N). A tile needs only 64+64 rows of X (K = HW = 49), which
// it stages in shared memory, computes the rows' norms from them, and runs a
// 4x4-per-thread SIMT product with the inverse-norm scaling in the epilogue.
// ss_space is one block per sample: it streams X through shared memory in
// 64-channel chunks, accumulates the 49x49 Gram in registers, and takes the
// norms from the Gram's diagonal (the same sums of squares).
#include "common.cuh"

namespace {

using ffr::from_f;
using ffr::to_f;

constexpr int TILE = 64;   // ss_channel tile side
constexpr int KMAX = 64;   // largest HW the kernels take
constexpr int CHUNK = 64;  // channels per ss_space stage
constexpr int SPACE_PER_THREAD = KMAX * KMAX / 256;

template <typename T>
__global__ void __launch_bounds__(256)
ss_channel_kernel(const T* __restrict__ x, T* __restrict__ out, int c, int hw) {
  __shared__ __align__(16) float As[KMAX][TILE + 4];  // As[k][i] = X[c0 + i, k]
  __shared__ __align__(16) float Bs[KMAX][TILE + 4];  // Bs[k][j] = X[d0 + j, k]
  __shared__ float inv_a[TILE], inv_b[TILE];
  const int tiles = c / TILE;
  const int c0 = (blockIdx.x / tiles) * TILE, d0 = (blockIdx.x % tiles) * TILE;
  const int n = blockIdx.y;
  const T* xn = x + (size_t)n * c * hw;
  const int tid = threadIdx.x;
  for (int e = tid; e < TILE * hw; e += 256) {  // 64 rows of hw values are contiguous
    const int i = e / hw, k = e - i * hw;
    As[k][i] = to_f(xn[(size_t)c0 * hw + e]);
    Bs[k][i] = to_f(xn[(size_t)d0 * hw + e]);
  }
  __syncthreads();
  if (tid < TILE) {
    float s = 0.f;
    for (int k = 0; k < hw; ++k) s += As[k][tid] * As[k][tid];
    inv_a[tid] = ffr::inv_norm(s);
  } else if (tid < 2 * TILE) {
    const int j = tid - TILE;
    float s = 0.f;
    for (int k = 0; k < hw; ++k) s += Bs[k][j] * Bs[k][j];
    inv_b[j] = ffr::inv_norm(s);
  }
  __syncthreads();
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int k = 0; k < hw; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] += av[r] * bv[s];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    T* dst = out + ((size_t)n * c + c0 + i) * c + d0 + tx * 4;
#pragma unroll
    for (int s = 0; s < 4; ++s) dst[s] = from_f<T>(acc[r][s] * inv_a[i] * inv_b[tx * 4 + s]);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
ss_space_kernel(const T* __restrict__ x, T* __restrict__ out, int c, int hw) {
  __shared__ float Xs[CHUNK][KMAX];     // Xs[cc][p] = X[c0 + cc, p]
  __shared__ float G[KMAX * KMAX];      // the Gram, for the diagonal
  __shared__ float inv[KMAX];
  const int n = blockIdx.x, tid = threadIdx.x;
  const int nout = hw * hw;
  const T* xn = x + (size_t)n * c * hw;
  int pk[SPACE_PER_THREAD], qk[SPACE_PER_THREAD];
  float acc[SPACE_PER_THREAD];
#pragma unroll
  for (int k = 0; k < SPACE_PER_THREAD; ++k) {
    const int o = tid + 256 * k;
    const int oc = o < nout ? o : 0;  // idle slots read row 0 and are dropped
    pk[k] = oc / hw;
    qk[k] = oc - pk[k] * hw;
    acc[k] = 0.f;
  }
  for (int c0 = 0; c0 < c; c0 += CHUNK) {
    for (int e = tid; e < CHUNK * hw; e += 256) {
      const int cc = e / hw, p = e - cc * hw;
      Xs[cc][p] = to_f(xn[(size_t)c0 * hw + e]);
    }
    __syncthreads();
    for (int cc = 0; cc < CHUNK; ++cc) {
#pragma unroll
      for (int k = 0; k < SPACE_PER_THREAD; ++k) acc[k] += Xs[cc][pk[k]] * Xs[cc][qk[k]];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < SPACE_PER_THREAD; ++k) {
    const int o = tid + 256 * k;
    if (o < nout) G[o] = acc[k];
  }
  __syncthreads();
  if (tid < hw) inv[tid] = ffr::inv_norm(G[tid * hw + tid]);
  __syncthreads();
  T* dst = out + (size_t)n * nout;
  for (int o = tid; o < nout; o += 256) {
    const int p = o / hw, q = o - p * hw;
    dst[o] = from_f<T>(G[o] * inv[p] * inv[q]);
  }
}

template <typename T>
void launch(const void* x, void* ss_space, void* ss_channel, int n, int c, int hw,
            cudaStream_t stream) {
  const int tiles = c / TILE;
  ss_space_kernel<T><<<n, 256, 0, stream>>>(static_cast<const T*>(x),
                                            static_cast<T*>(ss_space), c, hw);
  ss_channel_kernel<T><<<dim3(tiles * tiles, n), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(ss_channel), c, hw);
}

}  // namespace

// x: (N, C, HW) contiguous; ss_space: (N, HW, HW); ss_channel: (N, C, C).
// The wrapper checks C % 64 == 0, C % CHUNK == 0 and HW <= 64.
extern "C" int self_similarity_launch(const void* x, void* ss_space, void* ss_channel, int n,
                                      int c, int hw, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, ss_space, ss_channel, n, c, hw, s);
  else
    launch<float>(x, ss_space, ss_channel, n, c, hw, s);
  return (int)cudaGetLastError();
}
