// RecNet's whole channel-attention branch at inference, fp32 or bf16 in and
// out, fp32 inside: one thread-block-cluster launch, with the two large
// products on the tensor cores as 3xTF32. The (C, C) attention matrix M
// never leaves registers.
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
// Bound on the H100 at C=512, HW=49, N=256: the two products h W5^T and
// M X are 10.87 GFLOP; the fp32 parity bar needs each as three TF32
// products (below), 0.066 ms at 495 TFLOP/s. The rest (t, h, the affines,
// 1.77 GFLOP) takes 0.026 ms at the fp32 SIMT rate of 67 TFLOP/s and the
// bytes (51 MB) 0.015 ms. All 12.6 GFLOP on fp32 SIMT, as the kernel this
// one replaces computed them, would take 0.189 ms. In bf16, X is exact in
// TF32 and M X needs two products: 0.053 ms. The 67 M sigmoids per call
// (expf on the special-function units) are not counted.
//
// Why the split: one TF32 pass (10-bit mantissa) for both products puts
// the output 1.5e-2 off the fp32 plain version on the test weights, 100x
// the bound of 1e-4; with x = hi + lo (both TF32) and the products
// lo*hi + hi*lo + hi*hi it is 3-4e-5 off (emulated on the CPU,
// tests/test_torch_cb_split.py).
//
// Design: the branch is a sigmoid attention per sample, with h as the
// queries, W5 as the keys (bias b5), X as the values, and no softmax.
//   1. A cluster of K CTAs (K = 8 at C=512) takes one sample; each CTA owns
//      C/K rows of M (64 at C=512). t is the only reduction over all C
//      rows: each CTA sums its rows' share of t, and every CTA adds the K
//      partials in rank order through distributed shared memory, so all
//      get the same bits. No scratch in device memory, one launch.
//   2. Each CTA builds h for 64 of its rows on fp32 SIMT (4 x 4 tiles a
//      thread, float4 operands from shared memory).
//      Each of its 4 warps then holds 16 rows of h as TF32 hi/lo A
//      fragments of mma.sync m16n8k8 for the rest of the block.
//   3. The warp walks the C keys in chunks of 64, double-buffered in shared
//      memory by cp.async (W5 rows and X rows of the chunk): S = h W5^T
//      (3xTF32), + b5 and the sigmoid in the accumulator registers, P split
//      into hi/lo, and O += P X (3xTF32 in fp32, 2 products in bf16) into a
//      16 x 56 accumulator of 28 registers a thread, stored once. Each
//      k-step's products are summed in a fresh accumulator and added to O
//      in fp32: the tensor cores' sums round toward zero, and carried in O
//      over all 192 steps they put the output 2-3e-4 off the plain version
//      on the H100.
//   The accumulator of m16n8k8 holds (row g, columns 2t, 2t+1) in a thread
//   where the A operand wants (row g, columns t, t+4). Instead of moving P
//   between threads, the key order inside each k-step of P X is permuted
//   (`Keys`): A's column t is the key of S's column 2t and A's column t+4
//   that of S's column 2t+1, and X's B fragment reads the same two keys.
//   The permutation also picks which keys share a k-step, so that the B
//   fragments of X's unpadded rows (HW=49) meet no bank conflict; W5's rows
//   are stored in that order when they are copied in.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using ffr::from_f;
using ffr::to_f;

constexpr int kThreads = 128;    // 4 warps, 16 rows of M each
constexpr int K1 = 32;           // Conv4Channel bottleneck width
constexpr int HWMAX = 56;        // largest HW the kernel takes: 7 n-tiles of 8
constexpr int NT = HWMAX / 8;
constexpr int BM = 64;           // rows of M per block of a CTA
constexpr int BD = 64;           // keys per chunk
constexpr int W5S = K1 + 4;      // W5 chunk row stride: B fragments free of conflicts
constexpr int XS = HWMAX + 4;    // ghat row stride (float4 rows)
constexpr int XT = BM + 4;       // x^T row stride (float4 rows)
constexpr int HT = BM + 8;       // h^T row stride: its A fragments free of conflicts
constexpr int kMaxCluster = 8;
constexpr int kVecT = (K1 * HWMAX / 4 + kThreads - 1) / kThreads;  // float4s of t a thread sums

// Shared memory: t (the partials, then the sum), then one of three stages.
// The SIMT stages give each thread a 4 x 4 tile of their output and read
// float4 rows, so a float4 of each operand feeds 16 FMAs.
struct StageT {  // partial t of a block of rows
  float xs[BM][XS];       // ghat rows
  float ws[BM][K1 + 4];   // W1s[:, rows]^T
};
struct StageH {  // h of a block of rows
  float xt[HWMAX][XT];    // x^T
  float w1ft[HWMAX][K1];  // W1f^T
  float wct[K1][K1 + 4];  // the layer's Wc^T
  float ht[K1][HT];       // h^T
  float inv[BM];
};
struct StageB {  // the attention loop: two buffers of X rows and W5 rows
  float x[2][BD * HWMAX];  // flat rows of the chunk, as T (bf16 fills half)
  float w5[2][BD * W5S];   // W5 rows in the order of `Keys`
};
union Stages {
  StageT t;
  StageH h;
  StageB b;
};
struct Smem {
  float t[K1 * HWMAX];  // partials as (32, HW), then t^T as (HW, 32)
  Stages u;
};
constexpr int kSmemBytes = (int)sizeof(Smem);
static_assert(4 * (kSmemBytes + 1024) <= 228 * 1024, "four CTAs an SM");

struct CbWeights {
  const float *w1f, *w1s, *b1, *s0, *wc1, *bc1, *s1, *wc2, *bc2, *s2, *w5, *b5;
};

// Key order inside a chunk of BD = 64 keys. S's n-tile kk (8 keys), column
// n = 2m + b, holds key kk + A*m + B*b; P X's k-step kk then reads the keys
// of S's columns 2t and 2t+1 in its slots t and t+4. X's rows of the two
// keys of a thread's B fragment sit A rows apart: with HW=49, A*49 is 8
// (fp32) or 16 (bf16) banks mod 32, so the 32 lanes (t: 0..3, g: 0..7)
// read 32 different banks.
template <typename T>
struct Keys {
  static constexpr int A = sizeof(T) == 4 ? 8 : 16;
  static constexpr int B = sizeof(T) == 4 ? 32 : 8;
  __device__ static int key(int kk, int n) { return kk + A * (n >> 1) + B * (n & 1); }
  // the position kk*8 + n of key j in the chunk's W5 rows
  __device__ static int slot(int j) {
    const int kk = j & 7;
    const int m = sizeof(T) == 4 ? (j >> 3) & 3 : j >> 4;
    const int b = sizeof(T) == 4 ? j >> 5 : (j >> 3) & 1;
    return kk * 8 + 2 * m + b;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// x rounded to TF32: to nearest, ties away from zero, as cvt.rna.tf32.f32
// does for finite x, in two integer operations (the cvt runs at a fraction
// of their rate)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, both TF32; x - hi is exact in fp32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d = a b + c, m16n8k8, TF32 in, fp32 accumulate. The tensor cores round
// each step's sum toward zero after aligning it to its largest term, so
// one accumulator carried over many steps drifts toward zero by about an
// ulp of itself a step; the callers sum a few steps in a fresh accumulator
// and add that into their total in fp32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2],
                                    const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  mma(d, a, b, d);
}

// An X value of a B fragment as TF32 hi/lo: a bf16 value is exact in TF32
// (lo = 0); 0 for a column at or past HW
__device__ __forceinline__ void x_frag(const float* xs, int i, bool ok, uint32_t& hi,
                                       uint32_t& lo) {
  split(ok ? xs[i] : 0.f, hi, lo);
}
__device__ __forceinline__ void x_frag(const __nv_bfloat16* xs, int i, bool ok, uint32_t& hi,
                                       uint32_t& lo) {
  hi = ok ? (uint32_t)__bfloat16_as_ushort(xs[i]) << 16 : 0u;
  lo = 0u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
cb_sigmoid_attention_kernel(const T* __restrict__ x, CbWeights w, T* __restrict__ out, int c,
                            int hw) {
  extern __shared__ __align__(16) float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const cg::cluster_group cluster = cg::this_cluster();
  const int k_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int rows = c / k_cta;  // this CTA's rows of M, in blocks of BM
  const int r_lo = rank * rows;
  const T* xn = x + (size_t)(blockIdx.x / k_cta) * c * hw;
  T* on = out + (size_t)(blockIdx.x / k_cta) * c * hw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int tj = tid & 7, ti = tid >> 3;  // SIMT tiles: 4 columns from 4tj, 4 rows from 4ti

  // ---- 1. this CTA's partial t = W1s[:, rows] ghat[rows] (t row 4tj+a,
  // column 4ti+b in a thread), then the sum over the cluster
  float tacc[4][4] = {};
  for (int r0 = r_lo; r0 < r_lo + rows; r0 += BM) {
    StageT& st = sm.u.t;
    for (int e = tid; e < BM * hw; e += kThreads) {
      const int i = e / hw, q = e - i * hw;
      st.xs[i][q] = to_f(xn[(size_t)r0 * hw + e]);
    }
    for (int e = tid; e < K1 * BM; e += kThreads) {
      const int o = e / BM, i = e - o * BM;
      st.ws[i][o] = w.w1s[(size_t)o * c + r0 + i];
    }
    __syncthreads();
    if (tid < BM) {
      float s = 0.f;
      for (int q = 0; q < hw; ++q) s += st.xs[tid][q] * st.xs[tid][q];
      const float inv = ffr::inv_norm(s);
      for (int q = 0; q < hw; ++q) st.xs[tid][q] *= inv;
    }
    __syncthreads();
    if (4 * ti < hw) {  // columns past HW are never stored
      for (int i = 0; i < BM; ++i) {
        const float4 wv = *reinterpret_cast<const float4*>(&st.ws[i][4 * tj]);
        const float4 xv = *reinterpret_cast<const float4*>(&st.xs[i][4 * ti]);
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w}, xb[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) tacc[a][b] += wa[a] * xb[b];
      }
    }
    __syncthreads();  // before the next block or stage overwrites the union
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * ti + b < hw) sm.t[(4 * tj + a) * hw + 4 * ti + b] = tacc[a][b];
  cluster.sync();  // every partial written
  // every CTA adds the K partials in rank order, float4 by float4: the
  // loads from all peers are independent and in flight together
  const int nout = K1 * hw, nvec = nout / 4;
  float4 tsum[kVecT];
#pragma unroll
  for (int k = 0; k < kVecT; ++k) tsum[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r < k_cta) {
      const float4* peer = reinterpret_cast<const float4*>(cluster.map_shared_rank(sm.t, r));
#pragma unroll
      for (int k = 0; k < kVecT; ++k) {
        const int v = tid + kThreads * k;
        if (v < nvec) {
          const float4 p = peer[v];
          tsum[k].x += p.x;
          tsum[k].y += p.y;
          tsum[k].z += p.z;
          tsum[k].w += p.w;
        }
      }
    }
  }
  cluster.sync();  // every peer has read this CTA's partials
#pragma unroll
  for (int k = 0; k < kVecT; ++k) {
    const int v = tid + kThreads * k;
    if (v < nvec) {
      const float vals[4] = {tsum[k].x, tsum[k].y, tsum[k].z, tsum[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 4 * v + e, j = o / hw, q = o - j * hw;
        sm.t[q * K1 + j] = vals[e];  // t^T
      }
    }
  }

  const int g = lane >> 2, tq = lane & 3;  // fragment row group, thread in group
  for (int r0 = r_lo; r0 < r_lo + rows; r0 += BM) {
    // ---- 2. h for rows r0..r0+BM-1 on SIMT (row 4ti+r, column 4tj+cc in
    // a thread), kept as h^T
    StageH& sh = sm.u.h;
    for (int e = tid; e < BM * hw; e += kThreads) {
      const int i = e / hw, q = e - i * hw;
      sh.xt[q][i] = to_f(xn[(size_t)r0 * hw + e]);
    }
    for (int e = tid; e < nout; e += kThreads) {
      const int q = e / K1, j = e - q * K1;
      sh.w1ft[q][j] = w.w1f[j * hw + q];
    }
    __syncthreads();
    if (tid < BM) {
      float s = 0.f;
      for (int q = 0; q < hw; ++q) s += sh.xt[q][tid] * sh.xt[q][tid];
      sh.inv[tid] = ffr::inv_norm(s);
    }
    __syncthreads();
    float hv[4][4];
    {
      // x W1f^T and x t^T; ghat t^T = inv * (x t^T) per row
      float a1[4][4] = {}, a2[4][4] = {};
      for (int q = 0; q < hw; ++q) {
        const float4 xv = *reinterpret_cast<const float4*>(&sh.xt[q][4 * ti]);
        const float4 wv = *reinterpret_cast<const float4*>(&sh.w1ft[q][4 * tj]);
        const float4 tv = *reinterpret_cast<const float4*>(&sm.t[q * K1 + 4 * tj]);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w}, wc[4] = {wv.x, wv.y, wv.z, wv.w},
                    tc[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            a1[r][cc] += xr[r] * wc[cc];
            a2[r][cc] += xr[r] * tc[cc];
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float inv = sh.inv[4 * ti + r], slope = w.s0[r0 + 4 * ti + r];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float h = a1[r][cc] + inv * a2[r][cc] + w.b1[4 * tj + cc];
          hv[r][cc] = h >= 0.f ? h : slope * h;
        }
      }
    }
    for (int layer = 0; layer < 2; ++layer) {
      const float* wc = layer ? w.wc2 : w.wc1;
      const float* bc = layer ? w.bc2 : w.bc1;
      const float* sl = layer ? w.s2 : w.s1;
      if (layer) __syncthreads();  // every read of ht is done
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        *reinterpret_cast<float4*>(&sh.ht[4 * tj + cc][4 * ti]) =
            make_float4(hv[0][cc], hv[1][cc], hv[2][cc], hv[3][cc]);
      for (int e = tid; e < K1 * K1; e += kThreads) {
        const int m = e / K1, j = e - m * K1;
        sh.wct[m][j] = wc[j * K1 + m];
      }
      __syncthreads();
      float acc[4][4] = {};
#pragma unroll 8
      for (int m = 0; m < K1; ++m) {
        const float4 hq = *reinterpret_cast<const float4*>(&sh.ht[m][4 * ti]);
        const float4 wq = *reinterpret_cast<const float4*>(&sh.wct[m][4 * tj]);
        const float hr[4] = {hq.x, hq.y, hq.z, hq.w}, wcol[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] += hr[r] * wcol[cc];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float slope = sl[r0 + 4 * ti + r];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float h = acc[r][cc] + bc[4 * tj + cc];
          hv[r][cc] = h >= 0.f ? h : slope * h;
        }
      }
    }
    __syncthreads();  // every read of ht is done
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      *reinterpret_cast<float4*>(&sh.ht[4 * tj + cc][4 * ti]) =
          make_float4(hv[0][cc], hv[1][cc], hv[2][cc], hv[3][cc]);
    __syncthreads();  // h is final

    // this warp's 16 rows of h as A fragments, TF32 hi/lo, K = 32: 4 k-steps
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float* c0 = &sh.ht[8 * ks + tq][16 * warp + g];
      const float* c4 = &sh.ht[8 * ks + tq + 4][16 * warp + g];
      split(c0[0], ah[ks][0], al[ks][0]);
      split(c0[8], ah[ks][1], al[ks][1]);
      split(c4[0], ah[ks][2], al[ks][2]);
      split(c4[8], ah[ks][3], al[ks][3]);
    }
    __syncthreads();  // stage H is free for the chunk buffers

    // ---- 3. the keys in chunks of BD: S, sigmoid, O += P X
    StageB& sb = sm.u.b;
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    auto issue = [&](int d0, int buf) {
      const char* src = reinterpret_cast<const char*>(xn + (size_t)d0 * hw);
      char* dst = reinterpret_cast<char*>(sb.x[buf]);
      const int xvec = BD * hw * (int)sizeof(T) / 16;
      for (int v = tid; v < xvec; v += kThreads) cp_async16(dst + 16 * v, src + 16 * v);
      for (int v = tid; v < BD * K1 / 4; v += kThreads) {
        const int j = v >> 3, part = v & 7;  // key j, 16-byte part of its row
        cp_async16(&sb.w5[buf][Keys<T>::slot(j) * W5S + 4 * part],
                   w.w5 + (size_t)(d0 + j) * K1 + 4 * part);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    float o[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    const int nch = c / BD;
    issue(0, 0);
    for (int ch = 0; ch < nch; ++ch) {
      const int buf = ch & 1, d0 = ch * BD;
      if (ch + 1 < nch) {
        issue(d0 + BD, buf ^ 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();  // chunk ch has landed for every thread
      const T* xs = reinterpret_cast<const T*>(sb.x[buf]);
      const float* w5s = sb.w5[buf];
#pragma unroll 1
      for (int kk = 0; kk < BD / 8; ++kk) {
        // S for keys Keys::key(kk, 0..7) of this warp's 16 rows: the two
        // cross terms and hi*hi in three chains of four k-steps
        float s[4], c1[4], c2[4];
        const float* wrow = w5s + (kk * 8 + g) * W5S + tq;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t bh[2], bl[2];
          split(wrow[8 * ks], bh[0], bl[0]);
          split(wrow[8 * ks + 4], bh[1], bl[1]);
          if (ks == 0) {
            mma(c1, al[0], bh, zero);
            mma(c2, ah[0], bl, zero);
            mma(s, ah[0], bh, zero);
          } else {
            mma(c1, al[ks], bh);
            mma(c2, ah[ks], bl);
            mma(s, ah[ks], bh);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += c1[e] + c2[e];
        // the thread's columns 2tq and 2tq+1 of S's n-tile kk: keys k0, k1
        const int k0 = Keys<T>::key(kk, 2 * tq), k1 = Keys<T>::key(kk, 2 * tq + 1);
        const float b0 = __ldg(w.b5 + d0 + k0), b1 = __ldg(w.b5 + d0 + k1);
        // P as the A fragment of P X: slot tq <- column 2tq, slot tq+4 <- 2tq+1
        uint32_t ph[4], pl[4];
        split(ffr::sigmoid(s[0] + b0), ph[0], pl[0]);  // (g, slot tq)
        split(ffr::sigmoid(s[2] + b0), ph[1], pl[1]);  // (g+8, slot tq)
        split(ffr::sigmoid(s[1] + b1), ph[2], pl[2]);  // (g, slot tq+4)
        split(ffr::sigmoid(s[3] + b1), ph[3], pl[3]);  // (g+8, slot tq+4)
        const int x0 = k0 * hw + g, x1 = k1 * hw + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bool ok = 8 * nt + g < hw;  // columns 49..55 are zero
          uint32_t xh[2], xl[2];
          x_frag(xs, x0 + 8 * nt, ok, xh[0], xl[0]);
          x_frag(xs, x1 + 8 * nt, ok, xh[1], xl[1]);
          float step[4];  // this k-step's share, then added to O in fp32
          mma(step, pl, xh, zero);
          if (sizeof(T) == 4) mma(step, ph, xl);  // bf16: X exact in TF32, xl = 0
          mma(step, ph, xh);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] += step[e];
        }
      }
      __syncthreads();  // every warp is done with buffer buf before it refills
    }
    // O (16 x 56 a warp) to out, columns below HW
    T* d_lo = on + (size_t)(r0 + 16 * warp + g) * hw;
    T* d_hi = d_lo + (size_t)8 * hw;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * tq;
      if (col < hw) {
        d_lo[col] = from_f<T>(o[nt][0]);
        d_hi[col] = from_f<T>(o[nt][2]);
      }
      if (col + 1 < hw) {
        d_lo[col + 1] = from_f<T>(o[nt][1]);
        d_hi[col + 1] = from_f<T>(o[nt][3]);
      }
    }
  }
}

template <typename T>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(cb_sigmoid_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(cb_sigmoid_attention_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <typename T>
cudaError_t launch(const void* x, const CbWeights& w, void* out, int n, int c, int hw,
                   int cluster, cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      c % (BM * cluster) || hw < 1 || hw > HWMAX || n < 1)
    return cudaErrorInvalidValue;
  cudaError_t e = prepare<T>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(n * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cb_sigmoid_attention_kernel<T>, static_cast<const T*>(x), w,
                         static_cast<T*>(out), c, hw);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace

// x, out: (N, C, HW) contiguous, of one type (float if is_bf16 == 0, else
// bf16); x and w5 16-byte aligned. Weights are fp32 and contiguous: w1f
// (32, HW), w1s (32, C), b1 (32), s0/s1/s2 (C), wc1/wc2 (32, 32), bc1/bc2
// (32), w5 (C, 32), b5 (C). `cluster` CTAs per sample (1, 2, 4 or 8, from
// ops/kernels/channel_branch.py::_cb_plan) each own C / cluster rows of M,
// a multiple of 64. Returns the launch's error, else cudaGetLastError();
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int channel_branch_launch(const void* x, const void* w1f, const void* w1s,
                                     const void* b1, const void* s0, const void* wc1,
                                     const void* bc1, const void* s1, const void* wc2,
                                     const void* bc2, const void* s2, const void* w5,
                                     const void* b5, void* out, int n, int c, int hw,
                                     int cluster, int is_bf16, void* stream) {
  const CbWeights w{static_cast<const float*>(w1f), static_cast<const float*>(w1s),
                    static_cast<const float*>(b1),  static_cast<const float*>(s0),
                    static_cast<const float*>(wc1), static_cast<const float*>(bc1),
                    static_cast<const float*>(s1),  static_cast<const float*>(wc2),
                    static_cast<const float*>(bc2), static_cast<const float*>(s2),
                    static_cast<const float*>(w5),  static_cast<const float*>(b5)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(x, w, out, n, c, hw, cluster, s);
  return (int)launch<float>(x, w, out, n, c, hw, cluster, s);
}
