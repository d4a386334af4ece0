// RecNet's whole channel-attention branch at inference, fp32 or bf16 in and
// out, fp32 inside. The (C, C) attention matrix M never reaches device
// memory.
//
// Replaces ffrnet_tpu/ops/pallas/channel_branch.py::channel_branch_pallas.
// From one sample's channel-major map X (C, HW):
//     ghat = X with its rows L2-normalized (eps 1e-12 on the norm)
//     t    = W1s ghat                                   (32, HW)
//     h    = X W1f^T + ghat t^T + b1, PReLU over rows   (C, 32)
//     h    = PReLU(h Wc1^T + bc1); h = PReLU(h Wc2^T + bc2)
//     M    = sigmoid(h W5^T + b5)                       (C, C)
//     out  = M X                                        (C, HW)
// The two (32, 32) affines are the collapsed inter-block Linear pairs,
// prepared in fp32 by the wrapper (`_collapse`). The output is (N, C, HW),
// which is NCHW; the JAX kernel returns its transpose (N, HW, C).
//
// Bound on the H100: operations. At C=512, HW=49 a sample is about 49 MFLOP
// (M: 16.8, M X: 25.7, the rest 6.6) against 200 KB of I/O in fp32: at
// N=256, 12.6 GFLOP is 0.19 ms at 67 TFLOP/s fp32 SIMT, while the bytes
// take 0.015 ms. M in device memory would add 1 MB written and read per
// sample.
//
// Design: t is the only reduction over all C rows, so a first launch
// (one block per sample) computes t and the rows' inverse norms. After it,
// every block of BM rows of M is independent: the second launch (grid
// C/BM x N) builds its rows of h in shared memory, then walks M's columns
// in chunks of BD: it forms the BM x BD tile of M in shared memory, and
// at once folds it into out += M_tile X[chunk] held in registers.
#include "common.cuh"

namespace {

using ffr::from_f;
using ffr::to_f;

constexpr int K1 = 32;           // Conv4Channel bottleneck width
constexpr int HWMAX = 56;        // largest HW the kernels take
constexpr int HWP = HWMAX + 1;   // padded row (odd: no bank conflicts)
constexpr int BM = 64;           // rows of M per block
constexpr int BD = 64;           // columns of M per chunk
constexpr int QPT = HWMAX / 4;   // output columns per thread (4 threads per row)

struct CbWeights {
  const float *w1f, *b1, *s0, *wc1, *bc1, *s1, *wc2, *bc2, *s2, *w5, *b5;
};

// t = W1s ghat and inv_r, one block per sample.
template <typename T>
__global__ void __launch_bounds__(256)
cb_prep_kernel(const T* __restrict__ x, const float* __restrict__ w1s,
               float* __restrict__ inv_r, float* __restrict__ t, int c, int hw) {
  __shared__ float Xs[BM][HWP];     // ghat rows c0..c0+BM-1
  __shared__ float Ws[K1][BM + 1];  // W1s[:, c0:c0+BM]
  const int n = blockIdx.x, tid = threadIdx.x;
  const T* xn = x + (size_t)n * c * hw;
  const int nout = K1 * hw;
  int ok[8], qk[8];
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int o = tid + 256 * k;
    const int oc = o < nout ? o : 0;
    ok[k] = oc / hw;
    qk[k] = oc - ok[k] * hw;
    acc[k] = 0.f;
  }
  for (int c0 = 0; c0 < c; c0 += BM) {
    for (int e = tid; e < BM * hw; e += 256) {
      const int i = e / hw, q = e - i * hw;
      Xs[i][q] = to_f(xn[(size_t)c0 * hw + e]);
    }
    for (int e = tid; e < K1 * BM; e += 256) {
      const int o = e / BM, i = e - o * BM;
      Ws[o][i] = w1s[(size_t)o * c + c0 + i];
    }
    __syncthreads();
    if (tid < BM) {
      float s = 0.f;
      for (int q = 0; q < hw; ++q) s += Xs[tid][q] * Xs[tid][q];
      const float inv = ffr::inv_norm(s);
      inv_r[(size_t)n * c + c0 + tid] = inv;
      for (int q = 0; q < hw; ++q) Xs[tid][q] *= inv;
    }
    __syncthreads();
    for (int i = 0; i < BM; ++i) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += Ws[ok[k]][i] * Xs[i][qk[k]];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int o = tid + 256 * k;
    if (o < nout) t[(size_t)n * nout + o] = acc[k];
  }
}

struct StageA {  // building h
  float Xr[BM][HWP];
  float Ts[K1][HWP];
  float W1f[K1][HWP];
  float Wc[K1][K1 + 1];
  float inv[BM];
};
struct StageB {  // M tiles and out
  float W5[BD][K1 + 1];
  float Xd[BD][HWP];
  float Ms[BM][BD + 1];
  float b5[BD];
};
union Stages {
  StageA a;
  StageB b;
};
static_assert(sizeof(Stages) + sizeof(float) * BM * (K1 + 1) <= 48 * 1024,
              "static shared memory above 48 KB");

template <typename T>
__global__ void __launch_bounds__(256)
cb_rows_kernel(const T* __restrict__ x, const float* __restrict__ inv_r,
               const float* __restrict__ t, CbWeights w, T* __restrict__ out, int c, int hw) {
  __shared__ float Hs[BM][K1 + 1];
  __shared__ Stages u;
  const int n = blockIdx.y, c0 = blockIdx.x * BM, tid = threadIdx.x;
  const T* xn = x + (size_t)n * c * hw;

  // ---- h for rows c0..c0+BM-1: BM*K1 = 2048 values, 8 per thread
  for (int e = tid; e < BM * hw; e += 256) {
    const int i = e / hw, q = e - i * hw;
    u.a.Xr[i][q] = to_f(xn[(size_t)c0 * hw + e]);
  }
  for (int e = tid; e < K1 * hw; e += 256) {
    const int o = e / hw, q = e - o * hw;
    u.a.Ts[o][q] = t[(size_t)n * K1 * hw + e];
    u.a.W1f[o][q] = w.w1f[e];
  }
  if (tid < BM) u.a.inv[tid] = inv_r[(size_t)n * c + c0 + tid];
  __syncthreads();
  float hv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int o = tid + 256 * k, i = o >> 5, j = o & 31;
    const float inv = u.a.inv[i];
    float a1 = 0.f, a2 = 0.f;
    for (int q = 0; q < hw; ++q) {
      const float xv = u.a.Xr[i][q];
      a1 += xv * u.a.W1f[j][q];
      a2 += (xv * inv) * u.a.Ts[j][q];
    }
    const float h = a1 + a2 + w.b1[j];
    hv[k] = h >= 0.f ? h : w.s0[c0 + i] * h;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int o = tid + 256 * k;
    Hs[o >> 5][o & 31] = hv[k];
  }
  for (int layer = 0; layer < 2; ++layer) {
    const float* wc = layer ? w.wc2 : w.wc1;
    const float* bc = layer ? w.bc2 : w.bc1;
    const float* sl = layer ? w.s2 : w.s1;
    __syncthreads();  // Hs written; the previous layer's Wc reads are done
    for (int e = tid; e < K1 * K1; e += 256) u.a.Wc[e / K1][e % K1] = wc[e];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int o = tid + 256 * k, i = o >> 5, j = o & 31;
      float s = 0.f;
#pragma unroll 8
      for (int m = 0; m < K1; ++m) s += Hs[i][m] * u.a.Wc[j][m];
      s += bc[j];
      hv[k] = s >= 0.f ? s : sl[c0 + i] * s;
    }
    __syncthreads();  // every read of Hs is done
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int o = tid + 256 * k;
      Hs[o >> 5][o & 31] = hv[k];
    }
  }
  __syncthreads();  // h is final; stage A's shared memory is free

  // ---- M tiles (BM x BD) and out = M X, out kept in registers
  const int ty = tid >> 4, tx = tid & 15;  // M tile: rows ty*4+r, cols tx+16*s
  const int ri = tid >> 2, qo = tid & 3;   // out: row ri, cols qo+4*k
  float oacc[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) oacc[k] = 0.f;
  for (int d0 = 0; d0 < c; d0 += BD) {
    for (int e = tid; e < BD * K1; e += 256) u.b.W5[e / K1][e % K1] = w.w5[(size_t)d0 * K1 + e];
    if (tid < BD) u.b.b5[tid] = w.b5[d0 + tid];
    for (int e = tid; e < BD * hw; e += 256) {
      const int jj = e / hw, q = e - jj * hw;
      u.b.Xd[jj][q] = to_f(xn[(size_t)d0 * hw + e]);
    }
    __syncthreads();
    float m[4][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < K1; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Hs[ty * 4 + r][kk];
#pragma unroll
      for (int s = 0; s < 4; ++s) b[s] = u.b.W5[tx + 16 * s][kk];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) m[r][s] += a[r] * b[s];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        u.b.Ms[ty * 4 + r][tx + 16 * s] = ffr::sigmoid(m[r][s] + u.b.b5[tx + 16 * s]);
    __syncthreads();
    for (int jj = 0; jj < BD; ++jj) {
      const float mv = u.b.Ms[ri][jj];
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        const int q = qo + 4 * k;
        if (q < hw) oacc[k] += mv * u.b.Xd[jj][q];
      }
    }
    __syncthreads();  // before the next chunk overwrites W5, Xd, Ms
  }
  T* dst = out + ((size_t)n * c + c0 + ri) * hw;
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int q = qo + 4 * k;
    if (q < hw) dst[q] = from_f<T>(oacc[k]);
  }
}

template <typename T>
void launch(const void* x, const CbWeights& w, const float* w1s, float* inv_r, float* t,
            void* out, int n, int c, int hw, cudaStream_t stream) {
  cb_prep_kernel<T><<<n, 256, 0, stream>>>(static_cast<const T*>(x), w1s, inv_r, t, c, hw);
  cb_rows_kernel<T><<<dim3(c / BM, n), 256, 0, stream>>>(static_cast<const T*>(x), inv_r, t, w,
                                                         static_cast<T*>(out), c, hw);
}

}  // namespace

// x, out: (N, C, HW) contiguous, of one type (float if is_bf16 == 0, else
// bf16). Weights are fp32 and contiguous: w1f (32, HW), w1s (32, C), b1 (32),
// s0/s1/s2 (C), wc1/wc2 (32, 32), bc1/bc2 (32), w5 (C, 32), b5 (C).
// inv_r (N, C) and t (N, 32, HW) are fp32 scratch. The wrapper checks
// C % 64 == 0 and HW <= 56. Returns cudaGetLastError() after the launches.
extern "C" int channel_branch_launch(const void* x, const void* w1f, const void* w1s,
                                     const void* b1, const void* s0, const void* wc1,
                                     const void* bc1, const void* s1, const void* wc2,
                                     const void* bc2, const void* s2, const void* w5,
                                     const void* b5, void* inv_r, void* t, void* out, int n,
                                     int c, int hw, int is_bf16, void* stream) {
  const CbWeights w{static_cast<const float*>(w1f), static_cast<const float*>(b1),
                    static_cast<const float*>(s0),  static_cast<const float*>(wc1),
                    static_cast<const float*>(bc1), static_cast<const float*>(s1),
                    static_cast<const float*>(wc2), static_cast<const float*>(bc2),
                    static_cast<const float*>(s2),  static_cast<const float*>(w5),
                    static_cast<const float*>(b5)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w1s_f = static_cast<const float*>(w1s);
  float* inv = static_cast<float*>(inv_r);
  float* tt = static_cast<float*>(t);
  if (is_bf16)
    launch<__nv_bfloat16>(x, w, w1s_f, inv, tt, out, n, c, hw, s);
  else
    launch<float>(x, w, w1s_f, inv, tt, out, n, c, hw, s);
  return (int)cudaGetLastError();
}
