"""Rate of the tensor-core instruction the channel-branch kernel runs on:
mma.sync m16n8k8 with TF32 operands and fp32 accumulators, on this card.

    python3 -m ffrnet_torch.tools.mma_rate

Needs an NVIDIA GPU and nvcc. One kernel issues independent chains of
mma.sync per warp; the script varies the warps per SM sub-partition and the
chains per warp and prints, for each, TFLOP/s and the cycles per mma.sync a
sub-partition spends at the card's largest SM clock, then the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess

from ffrnet_torch.ops.kernels import _build

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CHAINS>
__global__ void chains(float* out, int iters) {
  uint32_t a[4], b[2] = {__float_as_uint(0.5f), __float_as_uint(0.25f)};
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + 1e-3f * threadIdx.x + i);
  float d[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma(d[j], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// Milliseconds of the second of two launches of `blocks` x `threads` with
// `chains` (1, 2, 4 or 8) chains of `iters` mma.sync each; -1 on an error.
extern "C" float mma_rate_ms(int chains_per_warp, int blocks, int threads, int iters) {
  float* out = nullptr;
  if (cudaMalloc(&out, sizeof(float) * blocks * threads) != cudaSuccess) return -1.f;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    switch (chains_per_warp) {
      case 1: chains<1><<<blocks, threads>>>(out, iters); break;
      case 2: chains<2><<<blocks, threads>>>(out, iters); break;
      case 4: chains<4><<<blocks, threads>>>(out, iters); break;
      default: chains<8><<<blocks, threads>>>(out, iters); break;
    }
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  if (cudaGetLastError() != cudaSuccess) ms = -1.f;
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return ms;
}
"""

ITERS = 4096
FLOP_PER_MMA = 2 * 16 * 8 * 8


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "mma_rate.cu"
    lib = _build.BUILD_DIR / "libmma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    dll.mma_rate_ms.restype = ctypes.c_float
    return dll


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mma_rate: needs an NVIDIA GPU")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    dll = build()
    for warps_per_smsp in (1, 4, 8):
        for chains in (1, 2, 4, 8):
            blocks, threads = sms * warps_per_smsp, 128  # 4 warps a block, one per sub-partition
            ms = dll.mma_rate_ms(chains, blocks, threads, ITERS)
            if ms <= 0:
                raise SystemExit("mma_rate: the kernel failed")
            mmas = blocks * threads // 32 * chains * ITERS
            tflops = mmas * FLOP_PER_MMA / (ms * 1e-3) / 1e12
            cycles = ms * 1e-3 * clock_hz / (mmas / (4 * sms))
            print(f"[mma_rate] {warps_per_smsp} warps a sub-partition, {chains} chains a warp: "
                  f"{tflops:.1f} TFLOP/s, {cycles:.2f} cycles per mma.sync at "
                  f"{clock_hz / 1e6:.0f} MHz", flush=True)
    print(smi("name,power.limit"))


if __name__ == "__main__":
    main()
