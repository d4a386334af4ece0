// Spatial and channel self-similarity of a feature map, fp32 or bf16 in,
// the same type out, fp32 inside: one launch for both Grams.
//
// Replaces ffrnet_tpu/ops/pallas/self_similarity.py::self_similarity_pallas.
// X is one sample's (C, HW) channel-major map (NCHW without the copy):
//     ss_space[p,q]   = (X^T X)[p,q] * (inv_r[p] * inv_r[q])   (HW, HW)
//     ss_channel[c,d] = (X X^T)[c,d] * (inv_s[c] * inv_s[d])   (C, C)
//     inv = 1 / max(||row||, 1e-12), from the same X as the Gram.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 SIMT) at N=256, C=512,
// HW=49: a sample reads 100 KB of X and writes 9.6 KB of ss_space and 1 MB
// of ss_channel in fp32, 0.297 GB in all, 0.0885 ms; both Grams are
// symmetric, so their upper triangles (with the norms) are 3.63 GFLOP,
// 0.0542 ms on fp32 SIMT. fp32 is bound by bytes (0.0885 ms), bf16 by
// operations on SIMT (0.0542 ms against 0.0443 ms of bytes). ss_channel is
// 90% of the bytes: the kernel is a write stream with a product attached.
// Its bf16 products run on the tensor cores (products of bf16 values are
// exact in fp32; only the order of the fp32 sums changes), where they take
// 0.004 ms, so there bytes bound it: 0.0443 ms.
//
// Design: one launch, a grid of work items of 256 threads, two CTAs an SM
// (the plan, ops/kernels/self_similarity.py::_ss_plan, sizes the shared
// memory; 128 registers a thread), so that one CTA's stores stream out
// while the other computes. Every item bulk-copies the 128-row panels of X
// it needs (cp.async.bulk, 128 * HW contiguous values, one mbarrier) into
// shared memory and repacks them there with all threads, the rows' norms
// summed on the way; no value of X is loaded element by element.
//   * Items 0..N-1 are the ss_space Grams, one per sample, first in the
//     grid so that none is left for the tail. The CTA walks the panels of
//     128 channels, copied two ahead into a double buffer. fp32: each panel
//     is repacked into a 128 x HW4 panel (HW padded with zeros to HW4, the
//     next multiple of 4: 52 at HW=49); only the upper-triangle 4x4 blocks
//     are computed (91 of 169 at HW=49), each by two threads on the two
//     halves of every panel's channels, added in a fixed order; each value
//     is written to (p, q) and (q, p). bf16: the whole Gram, padded to
//     64x64, on the tensor cores (mma.sync m16n8k16, operands by ldmatrix
//     .trans from (128, KS) bf16 rows); (p, q) and (q, p) come from the
//     same products in the same order. The norms are the Gram's diagonal.
//   * The other items are the upper-triangle 128x128 tile pairs (I <= J) of
//     ss_channel, T(T+1)/2 per sample for T = ceil(C/128) (10 at C=512; an
//     odd multiple of 64 leaves the last tiles one valid 64-wide half, the
//     other masked). A diagonal tile skips its lower-left 64x64 quadrant,
//     the transpose of its upper-right one. The tile is scaled by the outer
//     product of the inverse norms, as acc * (inv[i] * inv[j]), stored once
//     as computed and once transposed, 16 bytes a thread, a half-warp on a
//     whole row segment: ss_channel[d, c] gets the very value of
//     ss_channel[c, d]. A diagonal quadrant is its own transpose, its two
//     halves made by the same products in the same order, so the output is
//     exactly symmetric. Stores are st.global.cs: the output is not read
//     again here and should not push X out of L2.
//     fp32 (SIMT): the panels are repacked k-major. Each thread holds a 4x4
//     block in each 64x64 quadrant, 64 accumulators, and takes four float4
//     operands per k-step for 64 FMAs: a byte of shared memory per FMA,
//     which the SM's 128 bytes a cycle just feed at its FMA rate (a 4x4
//     block alone needs two). The direct tile goes out from registers; each
//     off-diagonal quadrant is staged (16-byte groups XOR-swizzled,
//     conflict-free both ways) for the transpose.
//     bf16 (tensor cores): the panels are repacked as (128, KS) bf16 rows, k
//     padded with zeros to a multiple of 16, and mma.sync m16n8k16 sums in
//     fp32, each warp a 32x64 block (a diagonal tile's two lower-left warps
//     idle). The scaled tile is staged as computed and then transposed in a
//     (128, SS) bf16 tile, and each is stored by rows.
// X is read from device memory once; its panels are read again from L2
// (a panel by up to T+1 items; X is 25 MB at N=256 in fp32).
#include "common.cuh"

namespace {

using ffr::from_f;
using ffr::to_f;

constexpr int kThreads = 256;
constexpr int TILE = 128;  // ss_channel tile side; channels per panel
constexpr int HALF = 64;   // a tile is 2x2 quadrants of 64x64; C is a multiple of 64
constexpr int KMAX = 64;   // largest HW the kernel takes
constexpr int KS = 72;   // bf16 panel row stride: 64 values of k, 8 of padding
constexpr int SS = 136;  // bf16 staging row stride: 128 values, 8 of padding
constexpr int kMaxSmem = 232448;  // 227 KB, the most one block may take on sm_90
// a wait that outlasts this many cycles (seconds) traps instead of hanging
constexpr long long kWaitCycles = 1LL << 33;

// One CTA's shared memory, in this order; ops/kernels/self_similarity.py::
// _smem_bytes counts the same.
//   raw   two panels of 128 rows as copied (a tile pair's I and J, or the
//         ss_space item's double buffer)
//   pan   the repacked panels: a tile pair's two k-major (HW, 128) fp32
//         panels (in bf16: two (128, KS) bf16 panels, k padded with zeros
//         to a multiple of 16), or ss_space's (128, HW4) fp32 panel (in
//         bf16: (128, KS)); then a 64x64 fp32 staging quadrant (in bf16: a
//         (128, SS) staging tile), or ss_space's partial sums
//   inv   two panels' inverse norms
//   part  the rows' partial sums of squares, 2 per row and panel
//   bars  two mbarriers
struct Layout {
  unsigned int raw, pan, inv, part, bars, total;
};

__host__ __device__ inline unsigned int pan_bytes(int hw, int itemsize) {
  const unsigned int space = (unsigned int)TILE * ((hw + 3) & ~3) * 4;
  const unsigned int pair = itemsize == 2 ? 2u * TILE * KS * 2 : 2u * hw * TILE * 4;
  const unsigned int stage = itemsize == 2 ? TILE * SS * 2u : HALF * HALF * 4u;
  const unsigned int m = pair > space ? pair : space;
  return m > stage ? m : stage;
}

__host__ __device__ inline Layout layout(int hw, int itemsize) {
  Layout l;
  l.raw = 0;
  l.pan = (2u * TILE * hw * itemsize + 15) & ~15u;
  l.inv = l.pan + pan_bytes(hw, itemsize);
  l.part = l.inv + 2 * TILE * 4;
  l.bars = l.part + 2 * 2 * TILE * 4;
  l.total = l.bars + 2 * 8;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > kWaitCycles) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` from global `src` into shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ int panel_rows(int c, int p) { return min(TILE, c - p * TILE); }

// one thread: panel p of a sample's channels (panel_rows rows of HW
// contiguous values) into `dst`, completing on `bar`
template <typename T>
__device__ __forceinline__ void load_panel(T* dst, const T* xs, int c, int hw, int p,
                                           uint64_t* bar) {
  const uint32_t bytes = (uint32_t)panel_rows(c, p) * hw * sizeof(T);
  expect_bytes(bar, bytes);
  bulk_copy(dst, xs + (size_t)p * TILE * hw, bytes, bar);
}

// one thread: panels ti and tj (one if they are equal) into raw, both
// completing on `bar`
template <typename T>
__device__ __forceinline__ void load_pair(T* raw, const T* xs, int c, int hw, int ti, int tj,
                                          uint64_t* bar) {
  const uint32_t a = (uint32_t)panel_rows(c, ti) * hw * sizeof(T);
  const uint32_t b = ti == tj ? 0 : (uint32_t)panel_rows(c, tj) * hw * sizeof(T);
  mbar_init(bar);
  expect_bytes(bar, a + b);
  bulk_copy(raw, xs + (size_t)ti * TILE * hw, a, bar);
  if (b) bulk_copy(raw + TILE * hw, xs + (size_t)tj * TILE * hw, b, bar);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four consecutive fp32 outputs, 16 bytes, streamed
__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(a, b, c, d));
}

__device__ __forceinline__ void fma_4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b on the tensor cores: bf16 operands, whose products are exact in
// fp32, summed in fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ss_space of one sample in fp32, on SIMT: the upper-triangle 4x4 blocks
// of X^T X over the panels of 128 channels, each panel's channels split in
// two halves between two thread groups where the blocks fit twice in the
// CTA
__device__ void space_item(const float* __restrict__ xs, float* __restrict__ out, int c, int hw,
                           unsigned char* smem, const Layout& l) {
  float* raw = reinterpret_cast<float*>(smem + l.raw);
  float* q = reinterpret_cast<float*>(smem + l.pan);  // q[ch][p], row stride hw4
  float* inv = reinterpret_cast<float*>(smem + l.inv);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bars);
  const int tid = threadIdx.x;
  const int panels = (c + TILE - 1) / TILE, hw4 = (hw + 3) & ~3, m = hw4 / 4;
  const int blocks = m * (m + 1) / 2;
  const int split = 2 * blocks <= kThreads ? 2 : 1;
  const int half = split == 2 ? tid >> 7 : 0;
  const int w = split == 2 ? tid & 127 : tid;
  const bool active = w < blocks;
  int py = 0, rest = active ? w : 0;
  while (rest >= m - py) {
    rest -= m - py;
    ++py;
  }
  const int qx = py + rest;  // block (py, qx), py <= qx
  const int kper = TILE / split;
  const int panel_elems = TILE * hw;
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    for (int b = 0; b < 2 && b < panels; ++b)
      load_panel(raw + b * panel_elems, xs, c, hw, b, bars + b);
  }
  __syncthreads();
  const int row = tid >> 1;  // repack: 2 threads a channel
  float acc[4][4] = {};
  for (int p = 0; p < panels; ++p) {
    const int b = p & 1;
    mbar_wait(smem_addr(bars + b), (p >> 1) & 1);
    const bool valid = row < panel_rows(c, p);
    const float* src = raw + b * panel_elems + row * hw;
    for (int col = tid & 1; col < hw4; col += 2)
      q[row * hw4 + col] = valid && col < hw ? src[col] : 0.f;
    __syncthreads();
    // every thread is done with buffer b: refill it two panels ahead
    if (tid == 0 && p + 2 < panels) load_panel(raw + b * panel_elems, xs, c, hw, p + 2, bars + b);
    if (active) {
      const float* qa = q + half * kper * hw4 + py * 4;
      const float* qb = q + half * kper * hw4 + qx * 4;
#pragma unroll 4
      for (int k = 0; k < kper; ++k) fma_4x4(acc, ld4(qa + k * hw4), ld4(qb + k * hw4));
    }
    __syncthreads();
  }
  float* red = q;  // the second half's sums, added in a fixed order
  if (half == 1 && active) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(red + w * 16 + r * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  if (half == 0 && active) {
    if (split == 2) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 o = ld4(red + w * 16 + r * 4);
        acc[r][0] += o.x;
        acc[r][1] += o.y;
        acc[r][2] += o.z;
        acc[r][3] += o.w;
      }
    }
    if (py == qx) {  // the norms: the Gram's diagonal
#pragma unroll
      for (int r = 0; r < 4; ++r) inv[py * 4 + r] = ffr::inv_norm(acc[r][r]);
    }
  }
  __syncthreads();
  if (half == 0 && active) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pr = py * 4 + r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int pc = qx * 4 + s;
        if (pr < hw && pc < hw) {
          const float v = acc[r][s] * (inv[pr] * inv[pc]);
          out[pr * hw + pc] = v;
          if (py != qx) out[pc * hw + pr] = v;
        }
      }
    }
  }
}

// ss_space of one sample in bf16, on the tensor cores: each panel of 128
// channels repacked as (128, KS) bf16 rows, HW padded with zeros to 64, and
// the whole 64x64 Gram summed in fp32 by mma.sync m16n8k16 over all C
// channels, its operands loaded transposed (ldmatrix .trans), each warp a
// 16x32 block. (p, q) and (q, p) come from the same products in the same
// order, so the output is exactly symmetric; the norms are its diagonal.
__device__ void space_item(const __nv_bfloat16* __restrict__ xs, __nv_bfloat16* __restrict__ out,
                           int c, int hw, unsigned char* smem, const Layout& l) {
  using T = __nv_bfloat16;
  T* raw = reinterpret_cast<T*>(smem + l.raw);
  T* q = reinterpret_cast<T*>(smem + l.pan);  // q[ch][p], row stride KS
  float* inv = reinterpret_cast<float*>(smem + l.inv);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bars);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int panels = (c + TILE - 1) / TILE;
  const int panel_elems = TILE * hw;
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    for (int b = 0; b < 2 && b < panels; ++b)
      load_panel(raw + b * panel_elems, xs, c, hw, b, bars + b);
  }
  __syncthreads();
  const int wm = warp & 3, wn = warp >> 2;  // rows 16 wm.., columns 32 wn..
  const int r8 = lane >> 2, kp = lane & 3, j = lane >> 3, r = lane & 7;
  float acc[4][4] = {};
  for (int p = 0; p < panels; ++p) {
    const int b = p & 1;
    mbar_wait(smem_addr(bars + b), (p >> 1) & 1);
    // repack as in the bf16 channel_item: 8 channels by 4 pairs of p a warp
    // instruction, a warp every 8th block of 8 channels
    for (int cb = warp; cb < TILE / 8; cb += kThreads / 32) {
      const int ch = cb * 8 + r8;
      const T* src = raw + b * panel_elems + ch * hw;
      const bool valid = ch < panel_rows(c, p);
      for (int k = 2 * kp; k < 64; k += 8) {
        float v0 = 0.f, v1 = 0.f;
        if (valid) {
          if (k < hw) v0 = to_f(src[k]);
          if (k + 1 < hw) v1 = to_f(src[k + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(q + ch * KS + k) = __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncthreads();
    if (tid == 0 && p + 2 < panels) load_panel(raw + b * panel_elems, xs, c, hw, p + 2, bars + b);
    for (int ks = 0; ks < TILE; ks += 16) {
      // A[p][k] = q[ks + k][p]: matrix j of the four takes rows p 8 (j & 1)..
      // and k 8 (j >> 1)..; B[k][n] = q[ks + k][n]: matrix j takes k 8 (j &
      // 1).. and n 8 (j >> 1)..
      uint32_t a[4], b0[4], b1[4];
      ldmatrix_x4_trans(a, q + (ks + r + 8 * (j >> 1)) * KS + 16 * wm + 8 * (j & 1));
      ldmatrix_x4_trans(b0, q + (ks + r + 8 * (j & 1)) * KS + 32 * wn + 8 * (j >> 1));
      ldmatrix_x4_trans(b1, q + (ks + r + 8 * (j & 1)) * KS + 32 * wn + 16 + 8 * (j >> 1));
      mma_bf16(acc[0], a, b0[0], b0[1]);
      mma_bf16(acc[1], a, b0[2], b0[3]);
      mma_bf16(acc[2], a, b1[0], b1[1]);
      mma_bf16(acc[3], a, b1[2], b1[3]);
    }
    __syncthreads();
  }
  // accumulator (nt, e) is element (16 wm + lane/4 + 8 (e/2), 32 wn + 8 nt +
  // 2 (lane%4) + e%2)
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * wm + r8 + 8 * (e >> 1), col = 32 * wn + 8 * nt + 2 * kp + (e & 1);
      if (row == col) inv[row] = ffr::inv_norm(acc[nt][e]);
    }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * wm + r8 + 8 * (e >> 1), col = 32 * wn + 8 * nt + 2 * kp + (e & 1);
      if (row < hw && col < hw)
        out[row * hw + col] = from_f<T>(acc[nt][e] * (inv[row] * inv[col]));
    }
}

// thread (tx, ty) holds the 4x4 block at (4 ty, 4 tx) of each 64x64
// quadrant; a diagonal tile skips its lower-left quadrant, the transpose
// of its upper-right one
template <bool kDiag>
__device__ __forceinline__ void tile_gram(float (&acc)[2][2][4][4], const float* pa,
                                          const float* pb, int hw, int tx, int ty) {
#pragma unroll 2
  for (int k = 0; k < hw; ++k) {
    const float* ra = pa + k * TILE + ty * 4;
    const float* rb = pb + k * TILE + tx * 4;
    const float4 a0 = ld4(ra), a1 = ld4(ra + HALF), b0 = ld4(rb), b1 = ld4(rb + HALF);
    fma_4x4(acc[0][0], a0, b0);
    fma_4x4(acc[0][1], a0, b1);
    if (!kDiag) fma_4x4(acc[1][0], a1, b0);
    fma_4x4(acc[1][1], a1, b1);
  }
}

// one upper-triangle tile pair (ti <= tj) of ss_channel in fp32, on SIMT
__device__ void channel_item(const float* __restrict__ xs, float* __restrict__ out, int c,
                             int hw, int ti, int tj, unsigned char* smem, const Layout& l) {
  float* raw = reinterpret_cast<float*>(smem + l.raw);
  float* pa = reinterpret_cast<float*>(smem + l.pan);  // pa[k][i] = X[c0 + i, k]
  float* inv = reinterpret_cast<float*>(smem + l.inv);
  float* part = reinterpret_cast<float*>(smem + l.part);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + l.bars);
  const bool diag = ti == tj;
  const int np = diag ? 1 : 2;
  float* pb = diag ? pa : pa + hw * TILE;  // pb[k][j] = X[d0 + j, k]
  const int tid = threadIdx.x;
  const int c0 = ti * TILE, d0 = tj * TILE;
  const int rows_a = panel_rows(c, ti), rows_b = panel_rows(c, tj);
  const int panel_elems = TILE * hw;
  if (tid == 0) load_pair(raw, xs, c, hw, ti, tj, bar);
  __syncthreads();
  mbar_wait(smem_addr(bar), 0);
  {  // repack k-major in fp32, rows past C as zeros; a row's squares in two
     // partial sums
    const int i = tid & (TILE - 1), kq = tid >> 7;
    for (int p = 0; p < np; ++p) {
      const bool valid = i < (p ? rows_b : rows_a);
      const float* src = raw + p * panel_elems + i * hw;
      float* dst = p ? pb : pa;
      float ss = 0.f;
      for (int k = kq; k < hw; k += 2) {
        const float v = valid ? src[k] : 0.f;
        dst[k * TILE + i] = v;
        ss = fmaf(v, v, ss);
      }
      part[(p * 2 + kq) * TILE + i] = ss;
    }
  }
  __syncthreads();
  if (tid < np * TILE) {
    const float* s = part + (tid >> 7) * 2 * TILE + (tid & (TILE - 1));
    inv[tid] = ffr::inv_norm(s[0] + s[TILE]);
  }
  const int tx = tid & 15, ty = tid >> 4;
  float acc[2][2][4][4] = {};
  if (diag)
    tile_gram<true>(acc, pa, pb, hw, tx, ty);
  else
    tile_gram<false>(acc, pa, pb, hw, tx, ty);
  __syncthreads();  // the norms are in; the panels are free for staging
  // quadrants of rows (qr) and columns (qc) that lie inside C
  const int vr = rows_a > HALF ? 2 : 1, vc = rows_b > HALF ? 2 : 1;
  const float* ib = inv + (diag ? 0 : TILE);
#pragma unroll
  for (int qr = 0; qr < 2; ++qr) {
#pragma unroll
    for (int qc = 0; qc < 2; ++qc) {
      if (qr >= vr || qc >= vc || (diag && qr > qc)) continue;
      const float* ia = inv + qr * HALF + ty * 4;
      const float* ibq = ib + qc * HALF + tx * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[qr][qc][r][s] *= ia[r] * ibq[s];
        store4(out + (size_t)(c0 + qr * HALF + ty * 4 + r) * c + d0 + qc * HALF + tx * 4,
               acc[qr][qc][r][0], acc[qr][qc][r][1], acc[qr][qc][r][2], acc[qr][qc][r][3]);
      }
    }
  }
  // the transposes, a quadrant at a time: S[i][j] row-major, 16-byte group
  // g of row i stored at g ^ ((i >> 2) & 7); a quarter-warp's eight float4
  // land in eight bank groups both when written by rows and when read by
  // 4x4 blocks. A diagonal tile's diagonal quadrants are their own
  // transposes.
  float* stage = pa;
#pragma unroll
  for (int qr = 0; qr < 2; ++qr) {
#pragma unroll
    for (int qc = 0; qc < 2; ++qc) {
      if (qr >= vr || qc >= vc || (diag && qr >= qc)) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(stage + (ty * 4 + r) * HALF + ((tx ^ (ty & 7)) * 4)) =
            make_float4(acc[qr][qc][r][0], acc[qr][qc][r][1], acc[qr][qc][r][2],
                        acc[qr][qc][r][3]);
      __syncthreads();
      // thread (i4, jg) = (tx, ty) takes the block S[4 i4 .. +4][4 jg .. +4]
      float4 blk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        blk[r] = ld4(stage + (tx * 4 + r) * HALF + ((ty ^ (tx & 7)) * 4));
      float* dst = out + (size_t)(d0 + qc * HALF + ty * 4) * c + c0 + qr * HALF + tx * 4;
      store4(dst, blk[0].x, blk[1].x, blk[2].x, blk[3].x);
      store4(dst + c, blk[0].y, blk[1].y, blk[2].y, blk[3].y);
      store4(dst + 2 * c, blk[0].z, blk[1].z, blk[2].z, blk[3].z);
      store4(dst + 3 * c, blk[0].w, blk[1].w, blk[2].w, blk[3].w);
      __syncthreads();
    }
  }
}

// the bf16 staging tile's 128 rows of 128 values to `dst` (row stride c),
// 16 bytes a thread, a half-warp on a whole row; only the 64x64 quadrants
// (row half, column half) inside C (rh < vr, ch < vc), and of those with
// `lower_left` = 0 all but the lower-left one, with 1 only it, with -1 all
__device__ __forceinline__ void store_stage(const __nv_bfloat16* st, __nv_bfloat16* dst, int c,
                                            int vr, int vc, int lower_left) {
  const int tid = threadIdx.x, chunk = tid & 15;
#pragma unroll
  for (int it = 0; it < TILE / 16; ++it) {
    const int row = (tid >> 4) + 16 * it;
    const int rh = row / HALF, ch = chunk / 8;
    const bool ll = rh == 1 && ch == 0;
    if (rh >= vr || ch >= vc || (lower_left == 0 && ll) || (lower_left == 1 && !ll)) continue;
    __stcs(reinterpret_cast<uint4*>(dst + (size_t)row * c + chunk * 8),
           *reinterpret_cast<const uint4*>(st + row * SS + chunk * 8));
  }
}

// one upper-triangle tile pair (ti <= tj) of ss_channel in bf16, on the
// tensor cores: the panels repacked as bf16 (k padded with zeros to a
// multiple of 16), mma.sync m16n8k16 with fp32 sums, each warp a 32x64
// block of the tile (a diagonal tile's two lower-left warps idle). The
// scaled tile is staged in shared memory once as computed and once
// transposed, and each is stored by rows.
__device__ void channel_item(const __nv_bfloat16* __restrict__ xs,
                             __nv_bfloat16* __restrict__ out, int c, int hw, int ti, int tj,
                             unsigned char* smem, const Layout& l) {
  using T = __nv_bfloat16;
  T* raw = reinterpret_cast<T*>(smem + l.raw);
  T* sa = reinterpret_cast<T*>(smem + l.pan);  // sa[i][k] = X[c0 + i, k], row stride KS
  float* inv = reinterpret_cast<float*>(smem + l.inv);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + l.bars);
  const bool diag = ti == tj;
  const int np = diag ? 1 : 2;
  T* sb = diag ? sa : sa + TILE * KS;  // sb[j][k] = X[d0 + j, k]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = ti * TILE, d0 = tj * TILE;
  const int rows_a = panel_rows(c, ti), rows_b = panel_rows(c, tj);
  const int panel_elems = TILE * hw;
  const int kpad = (hw + 15) & ~15;
  if (tid == 0) load_pair(raw, xs, c, hw, ti, tj, bar);
  __syncthreads();
  mbar_wait(smem_addr(bar), 0);
  // repack: a warp instruction takes 8 rows by 4 pairs of k (the rows' 16
  // bytes land in distinct banks), a warp every 8th block of 8 rows; rows
  // past C and k past HW as zeros. A row's squares are summed over its 4
  // lanes by shuffles.
  {
    const int r8 = lane >> 2, kp = lane & 3;
    for (int p = 0; p < np; ++p) {
      const int rows = p ? rows_b : rows_a;
      T* dst = p ? sb : sa;
      for (int rb = warp; rb < TILE / 8; rb += kThreads / 32) {
        const int i = rb * 8 + r8;
        const T* src = raw + p * panel_elems + i * hw;
        float ss = 0.f;
        for (int k = 2 * kp; k < kpad; k += 8) {
          float v0 = 0.f, v1 = 0.f;
          if (i < rows) {
            if (k < hw) v0 = to_f(src[k]);
            if (k + 1 < hw) v1 = to_f(src[k + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(dst + i * KS + k) = __floats2bfloat162_rn(v0, v1);
          ss = fmaf(v1, v1, fmaf(v0, v0, ss));
        }
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        if (kp == 0) inv[p * TILE + i] = ffr::inv_norm(ss);
      }
    }
  }
  __syncthreads();
  const int wm = warp & 3, wn = warp >> 2;  // rows 32 wm.., columns 64 wn..
  const bool idle = diag && wm >= 2 && wn == 0;
  float acc[2][8][4] = {};
  if (!idle) {
    for (int ks = 0; ks < kpad; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], sa + (32 * wm + 16 * mt + (lane & 15)) * KS + ks + (lane >> 4) * 8);
#pragma unroll
      for (int nq = 0; nq < 4; ++nq) {  // two n8 tiles at a time
        uint32_t b[4];
        ldmatrix_x4(b, sb + (64 * wn + 16 * nq + ((lane >> 4) << 3) + (lane & 7)) * KS + ks +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * nq], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * nq + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();  // the panels are free for staging
  const float* ib = inv + (diag ? 0 : TILE);
  const int vr = rows_a > HALF ? 2 : 1, vc = rows_b > HALF ? 2 : 1;
  T* st = sa;
  // accumulator (mt, nt, e) is element (32 wm + 16 mt + lane/4 + 8 (e/2),
  // 64 wn + 8 nt + 2 (lane%4) + e%2) of the tile
  if (!idle) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 32 * wm + 16 * mt + (lane >> 2) + 8 * h;
          const int col = 64 * wn + 8 * nt + 2 * (lane & 3);
          const float v0 = acc[mt][nt][2 * h] * (inv[row] * ib[col]);
          const float v1 = acc[mt][nt][2 * h + 1] * (inv[row] * ib[col + 1]);
          acc[mt][nt][2 * h] = v0;
          acc[mt][nt][2 * h + 1] = v1;
          *reinterpret_cast<__nv_bfloat162*>(st + row * SS + col) = __floats2bfloat162_rn(v0, v1);
        }
  }
  __syncthreads();
  store_stage(st, out + (size_t)c0 * c + d0, c, vr, vc, diag ? 0 : -1);
  __syncthreads();
  // the transpose: all of an off-diagonal tile; of a diagonal one only
  // the upper-right quadrant (warps wm < 2, wn = 1), which becomes the
  // lower-left; its diagonal quadrants are their own transposes
  if (!idle && (!diag || (wm < 2 && wn == 1))) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 32 * wm + 16 * mt + (lane >> 2) + 8 * (e >> 1);
          const int col = 64 * wn + 8 * nt + 2 * (lane & 3) + (e & 1);
          st[col * SS + row] = __float2bfloat16_rn(acc[mt][nt][e]);
        }
  }
  __syncthreads();
  store_stage(st, out + (size_t)d0 * c + c0, c, vc, vr, diag ? 1 : -1);
}

// grid: N ss_space items, then N * pairs tile-pair items (sample-major)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ss_gram_kernel(const T* __restrict__ x, T* __restrict__ ss_space, T* __restrict__ ss_channel,
               int n, int c, int hw, int pairs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = layout(hw, sizeof(T));
  const int item = blockIdx.x;
  if (item < n) {
    space_item(x + (size_t)item * c * hw, ss_space + (size_t)item * hw * hw, c, hw, smem, l);
    return;
  }
  const int q = item - n;
  const int sample = q / pairs;
  int rest = q - sample * pairs, ti = 0;
  const int tiles = (c + TILE - 1) / TILE;
  while (rest >= tiles - ti) {
    rest -= tiles - ti;
    ++ti;
  }
  channel_item(x + (size_t)sample * c * hw, ss_channel + (size_t)sample * c * c, c, hw, ti,
               ti + rest, smem, l);
}

template <typename T>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(ss_gram_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ss_gram_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <typename T>
cudaError_t launch(const void* x, void* ss_space, void* ss_channel, int n, int c, int hw,
                   int pairs, int smem, cudaStream_t stream) {
  const int tiles = (c + TILE - 1) / TILE;
  if (n < 1 || c < HALF || c % HALF || hw < 1 || hw > KMAX ||
      pairs != tiles * (tiles + 1) / 2 || (unsigned int)smem < layout(hw, sizeof(T)).total ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t e = prepare<T>();
  if (e != cudaSuccess) return e;
  ss_gram_kernel<T><<<n + n * pairs, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(ss_space), static_cast<T*>(ss_channel), n, c,
      hw, pairs);
  return cudaGetLastError();
}

}  // namespace

// x: (N, C, HW) contiguous, 16-byte aligned; ss_space: (N, HW, HW);
// ss_channel: (N, C, C) 16-byte aligned; all of one type (float if
// is_bf16 == 0, else bf16). The plan (pairs = T(T+1)/2 tile pairs per
// sample for T = ceil(C/128), smem bytes per CTA) comes from
// ops/kernels/self_similarity.py::_ss_plan. Returns the launch's error;
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int self_similarity_launch(const void* x, void* ss_space, void* ss_channel, int n,
                                      int c, int hw, int pairs, int smem, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, ss_space, ss_channel, n, c, hw, pairs, smem, s);
  return (int)launch<float>(x, ss_space, ss_channel, n, c, hw, pairs, smem, s);
}
