// Squeeze-excitation gate of the IR-SE encoder, NCHW, fp32 or bf16: one
// thread-block-cluster launch per gate.
//
// Replaces ffrnet_tpu/ops/pallas/se_gating.py::se_gating_pallas. Per sample:
//     pooled = mean_HW(x)                          (C)      fp32
//     g      = sigmoid(relu(pooled W1^T) W2^T)     (C)      fp32
//     out    = x * g                               g cast to x's type first
//
// Bound on the H100: bytes. The gate's two mat-vecs are 4*C*C/16 FLOP per
// sample, nothing beside the map itself: at N=256 one IR-SE50 forward moves
// 3.65 GB through its 24 gates in fp32 (x read once, out written once),
// 1.089 ms at 3.35 TB/s.
//
// Design: the Pallas kernel kept one whole sample in VMEM. Here a cluster
// of K CTAs holds one sample in shared memory. In NCHW a sample's C rows of
// HW values are contiguous, so each CTA takes a contiguous range of C/K
// channels: one run of (C/K)*HW values. The wrapper's _se_plan picks the
// smallest K of 1, 2, 4, 8 whose slice, with this kernel's few KB of
// bookkeeping, leaves room for two fp32 or four bf16 CTAs on an SM; for
// IR-SE50 (fp32 maps of 784, 392, 196, 98 KB) that is K = 8, 4, 2, 1 in
// both types, a 98 KB slice in fp32 and a 49 KB one in bf16.
//   1. One thread bulk-copies the slice into shared memory in up to 8
//      chunks of whole channels (cp.async.bulk, one mbarrier each). Each
//      thread sums a (channel, segment) row of the slice as soon as its
//      chunk lands. A CTA's channels are whole, so their means need no
//      exchange.
//   2. Each CTA sums W1[:, own channels] . pooled[own], R partial hidden
//      values, and the cluster shares them through distributed shared
//      memory. Every CTA adds the K partials in rank order (so all agree),
//      applies relu and computes the gates of its own channels from
//      W2[own, :]. Each weight element is read once per sample.
//   3. The slice is scaled in shared memory by the gates cast to x's type
//      and written out with 16-byte stores. A CTA waits for its peers
//      before it exits, since they may still read its partial sums.
// What this does about the three-launch version it replaces (pool, gate,
// scale): x crosses device memory once in and once out, where the pool and
// the scale pass each read it (1.5x the bound's bytes wherever a stage map
// outgrew the 50 MB L2); one launch per gate, not three, and no launch of
// N blocks only; the pooled values and gates stay in shared memory, so the
// wrapper allocates no (N, C) scratch.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using ffr::from_f;
using ffr::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one block may take on sm_90
constexpr int kRowsPerWarp = 4;   // W1 rows a warp sums at once
// a wait that outlasts this many cycles (seconds) traps instead of hanging
constexpr long long kWaitCycles = 1LL << 33;

// One CTA's shared memory, in this order; ops/kernels/se_gating.py::
// _smem_bytes counts the same.
struct Layout {
  int segs;  // pool segments per channel: at least one row per thread
  unsigned int bars, part, gate, hpart, hidden, total;  // byte offsets, size
};

__host__ __device__ inline Layout layout(int cpc, int hw, int r, int itemsize) {
  Layout l;
  l.segs = (kThreads + cpc - 1) / cpc;
  l.bars = (unsigned int)cpc * hw * itemsize;              // after the slice
  l.part = l.bars + 8 * kMaxChunks;                        // mbarriers
  l.gate = l.part + 4u * cpc * l.segs;                     // pool partial sums
  l.hpart = l.gate + 4u * cpc;                             // means, then gates
  l.hidden = l.hpart + 4u * r;                             // partial hidden sums
  l.total = l.hidden + 4u * r;                             // hidden values
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (!done && clock64() - start > kWaitCycles) __trap();
  } while (!done);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
se_gate_cluster_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                       const T* __restrict__ w2, T* __restrict__ out, int c, int hw, int r,
                       int cpc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Layout l = layout(cpc, hw, r, sizeof(T));
  T* slice = reinterpret_cast<T*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bars);
  float* part = reinterpret_cast<float*>(smem + l.part);
  float* gate = reinterpret_cast<float*>(smem + l.gate);
  float* hpart = reinterpret_cast<float*>(smem + l.hpart);
  float* hidden = reinterpret_cast<float*>(smem + l.hidden);
  const int c0 = rank * cpc;
  const size_t base = ((size_t)(blockIdx.x / k) * c + c0) * hw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // chunks of whole channels whose sizes are multiples of 16 bytes (the
  // whole slice is, by the plan)
  int chunks = kMaxChunks;
  while (chunks > 1 && (cpc % chunks || (cpc / chunks) * hw * (int)sizeof(T) % 16))
    chunks >>= 1;
  const int chunk_ch = cpc / chunks;
  const uint32_t chunk_bytes = (uint32_t)chunk_ch * hw * sizeof(T);
  if (tid == 0) {
    for (int i = 0; i < chunks; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < chunks; ++i) {
      const uint32_t bar = smem_addr(bars + i);
      const size_t off = (size_t)i * chunk_ch * hw;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(chunk_bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slice + off)),
          "l"(x + base + off), "r"(chunk_bytes), "r"(bar)
          : "memory");
    }
  }
  __syncthreads();

  // 1. pool: one thread per (channel, segment) row, in channel order, so
  // the first chunk's rows start while the last chunk is still in flight
  const int segs = l.segs;
  const int seg_len = (hw + segs - 1) / segs;
  for (int row = tid; row < cpc * segs; row += kThreads) {
    const int ch = row / segs;
    const int lo = (row - ch * segs) * seg_len, hi = min(hw, lo + seg_len);
    mbar_wait(smem_addr(bars + ch / chunk_ch));
    const T* p = slice + (size_t)ch * hw;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int i = lo;
    for (; i + 4 <= hi; i += 4) {
      a0 += to_f(p[i]);
      a1 += to_f(p[i + 1]);
      a2 += to_f(p[i + 2]);
      a3 += to_f(p[i + 3]);
    }
    for (; i < hi; ++i) a0 += to_f(p[i]);
    part[row] = (a0 + a1) + (a2 + a3);
  }
  __syncthreads();
  for (int ch = tid; ch < cpc; ch += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < segs; ++j) sum += part[ch * segs + j];
    gate[ch] = sum / (float)hw;
  }
  __syncthreads();

  // 2. the gate: partial hidden sums over own channels, shared with the
  // cluster; then the gates of own channels. A warp sums kRowsPerWarp rows
  // of W1 at once, its lanes on consecutive channels (coalesced loads).
  for (int j0 = warp * kRowsPerWarp; j0 < r; j0 += kWarps * kRowsPerWarp) {
    float acc[kRowsPerWarp] = {};
    for (int i = lane; i < cpc; i += 32) {
      const float p = gate[i];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q)
        if (j0 + q < r) acc[q] += p * to_f(w1[(size_t)(j0 + q) * c + c0 + i]);
    }
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const float sum = ffr::warp_sum(acc[q]);
      if (lane == 0 && j0 + q < r) hpart[j0 + q] = sum;
    }
  }
  cluster.sync();
  for (int j = tid; j < r; j += kThreads) {
    float acc = 0.f;
    for (int q = 0; q < k; ++q) acc += cluster.map_shared_rank(hpart, q)[j];
    hidden[j] = fmaxf(acc, 0.f);
  }
  // this thread reads no peer's shared memory from here on
  cluster.barrier_arrive();
  __syncthreads();
  // one thread per channel reads its row of W2, 16 bytes at a time where
  // the rows allow it
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_w2 = r % kVec == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  for (int ch = tid; ch < cpc; ch += kThreads) {
    const T* row = w2 + (size_t)(c0 + ch) * r;
    float acc = 0.f;
    if (vec_w2) {
#pragma unroll 8
      for (int j = 0; j < r; j += kVec) {
        uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + j));
        const T* w = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int q = 0; q < kVec; ++q) acc += hidden[j + q] * to_f(w[q]);
      }
    } else {
      for (int j = 0; j < r; ++j) acc += hidden[j] * to_f(row[j]);
    }
    gate[ch] = to_f(from_f<T>(ffr::sigmoid(acc)));  // the gate in x's type
  }
  __syncthreads();

  // 3. scale and write once, 16 bytes a thread; a vector may span channels
  for (int i = 0; i < chunks; ++i) mbar_wait(smem_addr(bars + i));
  const unsigned int n_vec = (unsigned int)cpc * hw / kVec;
  for (unsigned int v = tid; v < n_vec; v += kThreads) {
    const unsigned int e = v * kVec;
    unsigned int ch = e / hw, next = (ch + 1) * hw;
    float g = gate[ch];
    uint4 raw = *reinterpret_cast<const uint4*>(slice + e);
    T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      if (e + q == next) {
        g = gate[++ch];
        next += hw;
      }
      vals[q] = from_f<T>(to_f(vals[q]) * g);
    }
    *reinterpret_cast<uint4*>(out + base + e) = raw;
  }
  // the peers may still be reading this CTA's hpart
  cluster.barrier_wait();
}

template <typename T>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(se_gate_cluster_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(se_gate_cluster_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

struct Config {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Config(int blocks, int cluster, int smem, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* w2, void* out, int n, int c,
                   int hw, int r, int cluster, int cpc, int smem, cudaStream_t stream) {
  const Layout l = layout(cpc, hw, r, sizeof(T));
  if (cluster < 1 || cluster > kMaxCluster || cpc * cluster != c || l.bars % 16 ||
      (unsigned int)smem < l.total || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t e = prepare<T>();
  if (e != cudaSuccess) return e;
  Config conf(n * cluster, cluster, smem, stream);
  e = cudaLaunchKernelEx(&conf.cfg, se_gate_cluster_kernel<T>, static_cast<const T*>(x),
                         static_cast<const T*>(w1), static_cast<const T*>(w2),
                         static_cast<T*>(out), c, hw, r, cpc);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <typename T>
cudaError_t max_clusters(int* count, int cluster, int smem, cudaStream_t stream) {
  cudaError_t e = prepare<T>();
  if (e != cudaSuccess) return e;
  Config conf(cluster, cluster, smem, stream);
  return cudaOccupancyMaxActiveClusters(count, se_gate_cluster_kernel<T>, &conf.cfg);
}

}  // namespace

// x, out: (N, C, H*W) contiguous, 16-byte aligned; w1: (R, C); w2: (C, R),
// all of one type (float if is_bf16 == 0, else bf16). The plan (cluster
// CTAs per sample, cpc = C / cluster channels per CTA, smem bytes per CTA)
// comes from ops/kernels/se_gating.py::_se_plan. Returns the launch's error,
// else cudaGetLastError(); cudaErrorInvalidValue for a plan that does not
// fit the shape.
extern "C" int se_gating_launch(const void* x, const void* w1, const void* w2, void* out, int n,
                                int c, int hw, int r, int cluster, int cpc, int smem,
                                int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, w1, w2, out, n, c, hw, r, cluster, cpc, smem, s);
  return (int)launch<float>(x, w1, w2, out, n, c, hw, r, cluster, cpc, smem, s);
}

// How many clusters of `cluster` CTAs with `smem` bytes each can be resident
// at once (cudaOccupancyMaxActiveClusters), written to *count; 0 means the
// plan can never launch.
extern "C" int se_gating_max_clusters(void* count, int cluster, int smem, int is_bf16,
                                      void* stream) {
  int* out = static_cast<int*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)max_clusters<__nv_bfloat16>(out, cluster, smem, s);
  return (int)max_clusters<float>(out, cluster, smem, s);
}
