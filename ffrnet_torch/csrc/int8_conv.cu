// int8 x int8 -> int32 convolution on Hopper's warpgroup tensor cores, with
// the dequantizing epilogue fused: out = float(acc) * deq[o] (+ bias[o]).
//
// Replaces ffrnet_tpu/ops/quant.py:143 (conv2d_int8: XLA's
// lax.conv_general_dilated on int8 operands with
// preferred_element_type=int32) and :169 (linear_int8: XLA's
// lax.dot_general on the same operands). The JAX package leaves both
// products to XLA; there is no Pallas original. PyTorch has no call that
// computes this function on a CUDA tensor (F.conv2d takes no integer types;
// torch._int_mm multiplies int8 matrices but has no im2col and no epilogue).
//
// Operands, as ffrnet_torch/ops/kernels/int8_conv.py prepares them:
//   x    (N, H, W, Cp) int8, NHWC, Cp a multiple of 64 (zero channels
//        appended to C).
//   w    (Coutp, KH, KW, Cp) int8, Coutp a multiple of 64 (zero rows and
//        channels appended), read as a 2-D (Coutp, K = KH KW Cp) matrix.
//   deq  (Cout,) fp32: s_x * s_w[o]; bias (Cout,) fp32 or null.
//   out  (N, Cout, Ho, Wo), fp32 or bf16 (NCHW, the port's layout).
// A Linear (K = 25088 for the encoder's output layer) is the same kernel
// as a 1x1 convolution over a 1x1 map with Cp = K.
//
// What bounds it on an H100 SXM: operations, 2 N Ho Wo Cout KH KW Cp at
// 1,979 TOP/s (int8 dense), for the 14x14 and 7x7 sites of stages 3-4; bytes
// for the rest, above all the fp32 or bf16 output written at 3.35 TB/s in
// stages 1-2, and the weights for the Linear.
//
// Design: implicit GEMM, rows m = (n, ho, wo), columns o, depth k = (r, s, c)
// in the packed weight's order, in tiles of 128 rows x BN columns (BN 64,
// 128 or 256 from the plan). K runs tap by tap in stages of BK channels:
// 128 bytes in the 128-byte swizzle, or 64 in the 64-byte swizzle where Cp
// is 64; a tap's last stage is zero-filled past Cp.
//   - Three warpgroups. One producer thread issues TMA loads; two consumer
//     warpgroups of 64 rows each run wgmma.mma_async m64nBNk32 s32.s8.s8
//     with both operands in shared memory, BK / 32 per stage. setmaxnreg
//     moves registers from the producer (40) to the consumers (232): an
//     m64n256 int32 accumulator is 128 registers a thread.
//   - A ring of 4 to 16 stages (192 KB) under mbarriers: "full" barriers
//     that the TMA bytes complete, "empty" barriers that each consumer warp
//     releases after its wgmma on the stage retired. No CTA barrier in the
//     loop.
//   - A (the implicit im2col of x): one TMA load a stage in im2col mode,
//     128 output pixels of one tap's BK channels, crossing rows and samples
//     in the hardware; taps in the zero padding and rows beyond N come back
//     as zeros, so padding and stride cost no instruction. (Gathering A with
//     16-byte cp.async copies, 1,024 a stage from 128 producer threads,
//     measured slower on an H100: their issue alone outlasted a stage's
//     products.)
//   - B (weights): one TMA load a stage of a BN x BK box of the packed
//     weight as a 2-D (Coutp, K) tensor; bytes past K are zeros. Where a
//     tap's last stage passes Cp, A is zero there and B's bytes of the next
//     tap add nothing.
//   - Persistent CTAs: with at least one tile per SM, the grid is one CTA
//     per SM and each walks tiles b, b + grid, ... (columns fastest, so
//     CTAs running together share their A rows in L2). The producer loads
//     the next tile while the consumers run the epilogue.
//   - Split-K in a thread-block cluster when the tiles fill less than one
//     wave (the Linear, small batches): the CTAs of a cluster of 2, 4 or 8
//     share one tile, each a whole number of K stages; the partial int32
//     tiles are summed through distributed shared memory into the leader
//     CTA, which runs the epilogue. One launch, no workspace, no atomics.
//   - Epilogue: deq and bias of the tile's columns to shared memory once a
//     tile; the accumulators staged 32 columns at a time (int32, column-
//     major), then fp32(acc) * deq (+ bias) with __fmul_rn / __fadd_rn and
//     16-byte stores of contiguous pixels of one channel (two 8-byte
//     stores where the run is 8-byte aligned only, pairs where it is less;
//     one output at a time where it crosses a sample). TMA stores of the staged tile measured
//     no faster on an H100, and a box cannot cross a sample boundary, which
//     a 64-row block does one time in three at 14x14.
// What holds it back now: the consumers run each tile's epilogue between
// two main loops, and the persistent CTAs reach it together, so the main
// loop and the output's writes take turns. On an H100 the main loop alone
// nears the operation bound at 14x14, and loads barely count; storing from
// the producer warpgroup's three idle warps instead (the consumers only
// staging the tile) measured slower, as did two CTAs an SM and a weight
// kept resident in shared memory.
//
// Exactness: int8 x int8 summed in int32 is exact (|acc| <= 127^2 * 25088
// = 4.05e8 < 2^31), whatever the order, tile or K split; the epilogue never
// contracts the multiply and add into an FMA, so it rounds as the plain
// twin does (two fp32 roundings) and the two agree to the bit.
#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BM = 128;            // output rows (pixels) per tile: two warpgroups of 64
constexpr int THREADS = 384;       // the producer warpgroup, then two consumer warpgroups
// registers move within a CTA: what the producer gives up, 128 x (168 - 40)
// of the 168 a thread the launch bounds allow, is what the consumers take,
// 256 x (232 - 168)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int MAX_CLUSTER = 8;
constexpr int CHUNK = 32;          // accumulator columns staged at a time by a warpgroup
constexpr int SPITCH = 68;         // staging column pitch in int32: 2 x 68 = 8 (mod 32) banks
constexpr int SMEM_LIMIT = 232448;
constexpr int RING_BYTES = 196608;  // the ring's share of shared memory
constexpr int MAX_STAGES = 16;
constexpr long long kWaitCycles = 1LL << 33;

// Shared memory of a CTA, from a 1024-byte aligned base (the swizzle's
// atom): the ring's A and B stages, the epilogue staging of both consumer
// warpgroups, their deq/bias and the barriers. BK is the K bytes of a stage:
// 128 in the 128-byte swizzle, or 64 in the 64-byte swizzle where Cp is 64.
// ops/kernels/int8_conv.py::_smem_bytes mirrors BYTES, _stages STAGES.
template <int BN, int BK>
struct Cfg {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGES = RING_BYTES / (A_BYTES + B_BYTES) < MAX_STAGES
                                    ? RING_BYTES / (A_BYTES + B_BYTES)
                                    : MAX_STAGES;
  static constexpr int NACC = BN / 2;  // int32 accumulators a consumer thread
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = STAGES * A_BYTES;
  static constexpr int ST_OFF = B_OFF + STAGES * B_BYTES;
  static constexpr int DEQ_OFF = ST_OFF + 2 * CHUNK * SPITCH * 4;
  static constexpr int BAR_OFF = DEQ_OFF + 2 * 2 * BN * 4;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;
  // wgmma descriptor: swizzle mode (1: 128 bytes, 2: 64 bytes) and the
  // stride between 8-row atoms
  static constexpr uint64_t LAYOUT = BK == 128 ? 1 : 2;
  static constexpr int SBO = 8 * BK;
  static_assert(BK == 64 || BK == 128, "stage width");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
  static_assert(2 * NACC * 128 * 4 <= STAGES * (A_BYTES + B_BYTES), "split-K partials");
};

struct Params {
  const int8_t* x;
  const float* deq;
  const float* bias;
  void* out;
  int n, h, w, cp, cout, kh, kw, stride, pad, ho, wo;
  int m;        // N Ho Wo
  int cblocks;  // K stages a window tap: ceil(Cp / BK)
  int kstages;  // KH KW cblocks
  int ntn;      // column tiles, Coutp / BN
  int tiles;    // row tiles x column tiles
  int cluster;  // CTAs a tile: 1 = persistent CTAs, else split-K
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// spin until the phase of `parity` completed; trap instead of hanging
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

// 128 rows (output pixels m0.. in (n, ho, wo) order) of BK channels from
// channel c of window tap (r, s), in im2col mode: (w, h, n) is the window's
// top-left input pixel of the first row; taps in the padding and rows
// beyond N are zeros
__device__ __forceinline__ void tma_load_im2col(uint32_t dst, const CUtensorMap* map, int c, int w,
                                                int h, int n, int s, int r, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(n), "r"(bar),
      "h"((unsigned short)s), "h"((unsigned short)r)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

// one 16-byte store of 4 fp32 or 8 bf16 outputs, each rounded as from_f does
__device__ __forceinline__ void store16(float* dst, const float* v) {
  *reinterpret_cast<int4*>(dst) = make_int4(__float_as_int(v[0]), __float_as_int(v[1]),
                                            __float_as_int(v[2]), __float_as_int(v[3]));
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// the same 16 bytes as two 8-byte stores, where dst is 8-byte aligned only
// (odd channel planes of a 14x14 bf16 output, every other at 7x7 fp32)
__device__ __forceinline__ void store8x2(float* dst, const float* v) {
  reinterpret_cast<uint2*>(dst)[0] = make_uint2(__float_as_uint(v[0]), __float_as_uint(v[1]));
  reinterpret_cast<uint2*>(dst)[1] = make_uint2(__float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ void store8x2(__nv_bfloat16* dst, const float* v) {
  reinterpret_cast<uint2*>(dst)[0] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  reinterpret_cast<uint2*>(dst)[1] = make_uint2(pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// the same run by pairs (8 bytes of fp32, 4 of bf16), where dst is aligned
// to its element only: pairs from the first or, if that is odd, the second
// element, the ends alone (7x7 maps, whose channel planes are 196 or 98
// bytes)
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(__float_as_uint(a), __float_as_uint(b));
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}
template <typename OutT>
__device__ __forceinline__ void store_pairs(OutT* dst, const float* v) {
  constexpr int VEC = 16 / sizeof(OutT);
  if ((reinterpret_cast<uintptr_t>(dst) & (2 * sizeof(OutT) - 1)) == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 2) store_pair(dst + e, v[e], v[e + 1]);
  } else {
    dst[0] = ffr::from_f<OutT>(v[0]);
#pragma unroll
    for (int e = 1; e < VEC - 1; e += 2) store_pair(dst + e, v[e], v[e + 1]);
    dst[VEC - 1] = ffr::from_f<OutT>(v[VEC - 1]);
  }
}

// wgmma descriptor of a K-major operand in the TMA's swizzle: 8-row atoms
// SBO bytes apart, start address in 16-byte units
template <typename C>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(C::SBO >> 4) << 32) | (C::LAYOUT << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x BN, int32, the warpgroup's fragment layout) (+)= a (64 x 32) b^T
// (BN x 32), int8 operands in shared memory; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_n64(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}


template <int BN>
__device__ __forceinline__ void wgmma(int* d, uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 64) {
    wgmma_n64(d, a, b, scale_d);
  } else if constexpr (BN == 128) {
    wgmma_n128(d, a, b, scale_d);
  } else {
    wgmma_n256(d, a, b, scale_d);
  }
}

// The producer warpgroup: one thread issues each stage's two TMA loads, the
// im2col rows of A and the weights' box of B, on the stage's full barrier.
template <int BN, int BK>
__device__ __forceinline__ void produce(const CUtensorMap* amap, const CUtensorMap* wmap,
                                        const Params& p, uint8_t* smem, int first, int step,
                                        int kbeg, int kcnt) {
  using C = Cfg<BN, BK>;
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
  if (threadIdx.x == 0) {
    const uint32_t a0 = smem_addr(smem + C::A_OFF), b0 = smem_addr(smem + C::B_OFF);
    const uint32_t full0 = smem_addr(smem + C::BAR_OFF), empty0 = full0 + 8 * C::STAGES;
    const int hw_out = p.ho * p.wo;
    uint32_t g = 0;  // stages issued
    for (int tile = first; tile < p.tiles; tile += step) {
      const int m0 = (tile / p.ntn) * BM, o0 = (tile % p.ntn) * BN;
      // the first row's window: top-left input pixel (wi, hi) of sample n
      const int n = m0 / hw_out, q = m0 - n * hw_out, ho = q / p.wo, wo = q - ho * p.wo;
      const int wi = wo * p.stride - p.pad, hi = ho * p.stride - p.pad;
      int tap = kbeg / p.cblocks, cb = kbeg - tap * p.cblocks;
      int r = tap / p.kw, s = tap - r * p.kw;
      for (int it = 0; it < kcnt; ++it, ++g) {
        const uint32_t slot = g % C::STAGES, full = full0 + 8 * slot;
        mbar_wait(empty0 + 8 * slot, ((g / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(full, C::A_BYTES + C::B_BYTES);
        tma_load_im2col(a0 + slot * C::A_BYTES, amap, cb * BK, wi, hi, n, s, r, full);
        tma_load_2d(b0 + slot * C::B_BYTES, wmap, tap * p.cp + cb * BK, o0, full);
        if (++cb == p.cblocks) {
          cb = 0;
          ++tap;
          if (++s == p.kw) {
            s = 0;
            ++r;
          }
        }
      }
    }
  }
  if (p.cluster > 1) {  // the consumers' two cluster barriers
    cluster_sync();
    cluster_sync();
  }
}

// One consumer warpgroup's 64 x BN tile (rows 64 cw.. of the CTA's tile):
// dequantize, stage 32 columns at a time, store runs of pixels per channel.
template <int BN, int BK, typename OutT>
__device__ __forceinline__ void epilogue(const Params& p, uint8_t* smem, const int* acc, int m0,
                                         int o0, int cw) {
  using C = Cfg<BN, BK>;
  constexpr int VEC = 16 / sizeof(OutT);      // pixels a 16-byte store
  constexpr int RUNS = 64 / VEC;              // runs of a staged column
  constexpr int UNITS = CHUNK * RUNS / 128;   // (column, run) pairs a thread a chunk
  const int wtid = threadIdx.x & 127, warp = wtid >> 5, g = (wtid & 31) >> 2, t = wtid & 3;
  int* st = reinterpret_cast<int*>(smem + C::ST_OFF) + cw * CHUNK * SPITCH;
  float* sdeq = reinterpret_cast<float*>(smem + C::DEQ_OFF) + cw * 2 * BN;
  float* sbias = sdeq + BN;
  // the last chunk's barrier of the previous tile ordered these after its reads
  for (int c = wtid; c < BN; c += 128) {
    const int o = o0 + c;
    sdeq[c] = o < p.cout ? p.deq[o] : 0.f;
    sbias[c] = (p.bias != nullptr && o < p.cout) ? p.bias[o] : 0.f;
  }
  const int hw = p.ho * p.wo;
  const int mw = m0 + 64 * cw;  // the warpgroup's first row: sample n0, pixel q0
  const int n0 = mw / hw, q0 = mw - n0 * hw;
  OutT* out = static_cast<OutT*>(p.out);
#pragma unroll
  for (int cc = 0; cc < BN / CHUNK; ++cc) {
    // fragment: acc[4 j + 2 h + e] is row 16 warp + g + 8 h, column 8 j + 2 t + e
#pragma unroll
    for (int jj = 0; jj < CHUNK / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st[(8 * jj + 2 * t + e) * SPITCH + 16 * warp + g + 8 * h] =
              acc[4 * (cc * (CHUNK / 8) + jj) + 2 * h + e];
    bar_sync(2 + cw, 128);
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = k * 128 + wtid;
      const int col = u / RUNS, r0 = (u % RUNS) * VEC;
      const int o = o0 + cc * CHUNK + col;
      const int m = mw + r0;
      if (o < p.cout && m < p.m) {
        const float dq = sdeq[cc * CHUNK + col], bs = sbias[cc * CHUNK + col];
        float v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const int4 a = *reinterpret_cast<const int4*>(st + col * SPITCH + r0 + e);
          v[e] = __fmul_rn(__int2float_rn(a.x), dq);
          v[e + 1] = __fmul_rn(__int2float_rn(a.y), dq);
          v[e + 2] = __fmul_rn(__int2float_rn(a.z), dq);
          v[e + 3] = __fmul_rn(__int2float_rn(a.w), dq);
        }
        if (p.bias != nullptr) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = __fadd_rn(v[e], bs);
        }
        int n = n0, q = q0 + r0;
        if (hw < 64) {  // the run may start samples later (7x7 maps, the Linear)
          n = m / hw;
          q = m - n * hw;
        } else if (q >= hw) {
          q -= hw;
          ++n;
        }
        OutT* dst = out + ((long long)n * p.cout + o) * hw + q;
        const uintptr_t align = reinterpret_cast<uintptr_t>(dst) & 15;
        if (m + VEC <= p.m && q + VEC <= hw) {  // the run lies in one sample
          if (align == 0)
            store16(dst, v);
          else if ((align & 7) == 0)
            store8x2(dst, v);
          else
            store_pairs(dst, v);
        } else {  // one output at a time, stepping (n, q) across samples
          const int last = min(VEC, p.m - m);
          for (int e = 0; e < last; ++e) {
            out[((long long)n * p.cout + o) * hw + q] = ffr::from_f<OutT>(v[e]);
            if (++q == hw) {
              q = 0;
              ++n;
            }
          }
        }
      }
    }
    bar_sync(2 + cw, 128);  // before the next chunk (or tile) overwrites the staging
  }
}

// A consumer warpgroup: the wgmma main loop over each tile's K stages, the
// split-K sum, the epilogue.
template <int BN, int BK, typename OutT>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem, int first, int step,
                                        int kcnt, int rank) {
  using C = Cfg<BN, BK>;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = (threadIdx.x >> 7) - 1, wtid = threadIdx.x & 127, lane = wtid & 31;
  const uint32_t a0 = smem_addr(smem + C::A_OFF) + cw * 64 * BK;
  const uint32_t b0 = smem_addr(smem + C::B_OFF);
  const uint32_t full0 = smem_addr(smem + C::BAR_OFF), empty0 = full0 + 8 * C::STAGES;
  int acc[C::NACC];
#pragma unroll
  for (int i = 0; i < C::NACC; ++i) acc[i] = 0;
  uint32_t g = 0;  // stages consumed
  for (int tile = first; tile < p.tiles; tile += step) {
#pragma unroll
    for (int i = 0; i < C::NACC; ++i) asm volatile("" : "+r"(acc[i])::"memory");
    for (int it = 0; it < kcnt; ++it, ++g) {
      const uint32_t slot = g % C::STAGES;
      mbar_wait(full0 + 8 * slot, (g / C::STAGES) & 1);
      wgmma_fence();
      const uint64_t da = desc<C>(a0 + slot * C::A_BYTES);
      const uint64_t db = desc<C>(b0 + slot * C::B_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)  // 32 bytes of K = 2 units of 16 in the descriptor
        wgmma<BN>(acc, da + 2 * kk, db + 2 * kk, (it | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products retired: release it
      if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % C::STAGES));
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % C::STAGES));
#pragma unroll
    for (int i = 0; i < C::NACC; ++i) asm volatile("" : "+r"(acc[i])::"memory");
    if (p.cluster > 1) {
      // split-K: every CTA but the leader leaves its partial tile in its
      // (now idle) ring, thread-major; the leader adds them in rank order
      int4* red = reinterpret_cast<int4*>(smem + C::A_OFF) + cw * (C::NACC / 4) * 128;
      if (rank != 0) {
        bar_sync(4, 256);  // both warpgroups' products retired: the ring is free
#pragma unroll
        for (int i = 0; i < C::NACC / 4; ++i)
          red[i * 128 + wtid] = make_int4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
      }
      cluster_sync();  // every partial written
      if (rank == 0) {
        cg::cluster_group cluster = cg::this_cluster();
        for (int pr = 1; pr < p.cluster; ++pr) {
          const int4* peer = cluster.map_shared_rank(red, pr);
#pragma unroll
          for (int i = 0; i < C::NACC / 4; ++i) {
            const int4 v = peer[i * 128 + wtid];
            acc[4 * i] += v.x;
            acc[4 * i + 1] += v.y;
            acc[4 * i + 2] += v.z;
            acc[4 * i + 3] += v.w;
          }
        }
      }
      cluster_sync();  // the leader has read every peer's partials
      if (rank != 0) continue;
    }
    epilogue<BN, BK, OutT>(p, smem, acc, (tile / p.ntn) * BM, (tile % p.ntn) * BN, cw);
  }
}

template <int BN, int BK, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    int8_conv_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap wmap, const __grid_constant__ Params p) {
  using C = Cfg<BN, BK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  if (threadIdx.x == 0) {
    const uint32_t full0 = smem_addr(smem + C::BAR_OFF), empty0 = full0 + 8 * C::STAGES;
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx; the TMA bytes complete it
      mbar_init(empty0 + 8 * s, 8);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&amap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
  }
  __syncthreads();
  // this CTA's tiles and K stages: persistent (tiles b, b + grid, ..., all
  // of K), or one tile per cluster with K split in whole stages by rank
  int first = blockIdx.x, step = gridDim.x, kbeg = 0, kcnt = p.kstages, rank = 0;
  if (p.cluster > 1) {
    rank = blockIdx.x % p.cluster;
    first = blockIdx.x / p.cluster;
    step = p.tiles;
    const int base = p.kstages / p.cluster, rem = p.kstages % p.cluster;
    kbeg = rank * base + min(rank, rem);
    kcnt = base + (rank < rem ? 1 : 0);
  }
  if (threadIdx.x < 128) {
    produce<BN, BK>(&amap, &wmap, p, smem, first, step, kbeg, kcnt);
  } else {
    consume<BN, BK, OutT>(p, smem, first, step, kcnt, rank);
  }
}

// cuTensorMapEncodeTiled / cuTensorMapEncodeIm2col through the runtime's
// driver entry point, so the library links against the runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

void* driver_entry(const char* name) {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(name, &ptr, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(name, &ptr, cudaEnableDefault, &q);
#endif
  return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? ptr : nullptr;
}

// the activation as a 4-D (C, W, H, N) int8 tensor read in im2col mode:
// BM output pixels a load, BK channels each, windows from (-pad, -pad) to
// (pad - KW + 1, pad - KH + 1) past the map's far corner, at the stride
// (corners in W, H order)
bool encode_activation(CUtensorMap* map, const Params& p, int bk) {
  static const EncodeIm2col encode =
      reinterpret_cast<EncodeIm2col>(driver_entry("cuTensorMapEncodeIm2col"));
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)p.cp, (cuuint64_t)p.w, (cuuint64_t)p.h, (cuuint64_t)p.n};
  const cuuint64_t strides[3] = {(cuuint64_t)p.cp, (cuuint64_t)p.cp * p.w,
                                 (cuuint64_t)p.cp * p.w * p.h};
  const int lower[2] = {-p.pad, -p.pad};
  const int upper[2] = {p.pad - (p.kw - 1), p.pad - (p.kh - 1)};
  const cuuint32_t elem[4] = {1, (cuuint32_t)p.stride, (cuuint32_t)p.stride, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(p.x), dims, strides,
                lower, upper, (cuuint32_t)bk, BM, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the packed weight as a 2-D (K, Coutp) int8 tensor read in BK x BN boxes;
// bytes past K are zeros
bool encode_weight(CUtensorMap* map, const int8_t* w, const Params& p, int coutp, int bn, int bk) {
  static const EncodeTiled encode =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  if (encode == nullptr) return false;
  const cuuint64_t k = (cuuint64_t)p.kh * p.kw * p.cp;
  const cuuint64_t dims[2] = {k, (cuuint64_t)coutp};
  const cuuint64_t strides[1] = {k};
  const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the kernel's shared memory above 48 KB, allowed once per instantiation
template <int BN, int BK, typename OutT>
cudaError_t prepare() {
  static const cudaError_t e =
      cudaFuncSetAttribute(int8_conv_kernel<BN, BK, OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN, BK>::BYTES);
  return e;
}

void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* at, int grid, int cluster,
                    int smem, cudaStream_t stream) {
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
}

template <int BN, int BK, typename OutT>
cudaError_t launch(const int8_t* w, const Params& p, int coutp, int grid, cudaStream_t stream) {
  const cudaError_t attr = prepare<BN, BK, OutT>();
  if (attr != cudaSuccess) return attr;
  CUtensorMap amap, wmap;
  if (!encode_activation(&amap, p, BK) || !encode_weight(&wmap, w, p, coutp, BN, BK))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  cluster_config(cfg, at, grid, p.cluster, Cfg<BN, BK>::BYTES, stream);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, int8_conv_kernel<BN, BK, OutT>, amap, wmap, p);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <int BN, int BK>
cudaError_t launch_bn(const int8_t* w, const Params& p, int coutp, int grid, int bf16,
                      cudaStream_t stream) {
  return bf16 ? launch<BN, BK, __nv_bfloat16>(w, p, coutp, grid, stream)
              : launch<BN, BK, float>(w, p, coutp, grid, stream);
}

template <int BK>
cudaError_t launch_bk(const int8_t* w, const Params& p, int coutp, int bn, int grid, int bf16,
                      cudaStream_t stream) {
  if (bn == 256) return launch_bn<256, BK>(w, p, coutp, grid, bf16, stream);
  if (bn == 128) return launch_bn<128, BK>(w, p, coutp, grid, bf16, stream);
  return launch_bn<64, BK>(w, p, coutp, grid, bf16, stream);
}

// Cfg's STAGES and BYTES of a plan
template <int BK>
void layout_of(int bn, int* stages, int* bytes) {
  if (bn == 256) {
    *stages = Cfg<256, BK>::STAGES, *bytes = Cfg<256, BK>::BYTES;
  } else if (bn == 128) {
    *stages = Cfg<128, BK>::STAGES, *bytes = Cfg<128, BK>::BYTES;
  } else {
    *stages = Cfg<64, BK>::STAGES, *bytes = Cfg<64, BK>::BYTES;
  }
}

}  // namespace

// x (N, H, W, Cp), w (Coutp, KH, KW, Cp) int8, 16-byte aligned; deq, bias
// (Cout,) fp32 (bias may be null); out (N, Cout, Ho, Wo) fp32 or bf16. The
// plan (BN, BK, ring stages, cluster = CTAs a tile, grid, shared memory)
// comes from ops/kernels/int8_conv.py::_int8_plan. Returns
// cudaErrorInvalidValue for a plan this kernel cannot run, else the
// launch's error or cudaGetLastError().
extern "C" int int8_conv_launch(const void* x, const void* w, const void* deq, const void* bias,
                                void* out, int n, int h, int wd, int cp, int cout, int coutp,
                                int kh, int kw, int stride, int pad, int ho, int wo,
                                int out_bf16, int bn, int bk, int stages, int cluster, int grid,
                                int smem, void* stream) {
  const long long m = (long long)n * ho * wo;
  if ((bn != 64 && bn != 128 && bn != 256) || coutp % bn || cp % 64 || cp < 64 || m < 1 ||
      m > (1LL << 30) || cout < 1 || cout > coutp || kh < 1 || kw < 1 || stride < 1 ||
      stride > 8 || pad < 0 || pad > 127 || kh - 1 - pad > 128 || kw - 1 - pad > 128 ||
      ho < 1 || wo < 1 || bk != (cp == 64 ? 64 : 128))
    return (int)cudaErrorInvalidValue;
  const int cblocks = (cp + bk - 1) / bk;
  const int kstages = kh * kw * cblocks;
  const int tiles = (int)((m + BM - 1) / BM) * (coutp / bn);
  const bool split = cluster > 1;
  int want_stages, want_smem;
  if (bk == 128)
    layout_of<128>(bn, &want_stages, &want_smem);
  else
    layout_of<64>(bn, &want_stages, &want_smem);
  if (stages != want_stages || smem != want_smem || smem > SMEM_LIMIT ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != MAX_CLUSTER) ||
      cluster > kstages || (split ? grid != tiles * cluster : (grid < 1 || grid > tiles)))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const int8_t*>(x), static_cast<const float*>(deq),
                 static_cast<const float*>(bias), out, n, h, wd, cp, cout, kh, kw, stride, pad,
                 ho, wo, (int)m, cblocks, kstages, coutp / bn, tiles, cluster};
  const int8_t* wq = static_cast<const int8_t*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bk == 128 ? launch_bk<128>(wq, p, coutp, bn, grid, out_bf16, s)
                         : launch_bk<64>(wq, p, coutp, bn, grid, out_bf16, s));
}
