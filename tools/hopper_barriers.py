#!/usr/bin/env python3
"""What a barrier costs on the card: nanoseconds (and cycles) per
cg::this_cluster().sync(), per __syncthreads() and per cooperative
grid.sync(), at a few cluster sizes, grid sizes and block widths, and the
time per launch of an empty cluster kernel queued back to back.

    python3 tools/hopper_barriers.py

Builds its kernels with nvcc into build/tools/ and prints one JSON line per
measurement, then the card's name, power limit and SM clock.  The port's
resident kernels (the fluid scan, the max-min rounds) spend much of a step
or a round in such barriers: ``chip_smoke.py`` imports :func:`barrier_ns`
to put a latency floor (rounds times one barrier) beside K2's byte bound.
"""
from __future__ import annotations

import ctypes
import functools
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__device__ unsigned long long g_cycles, g_ns;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// mode 0: cluster.sync(); 1: __syncthreads(); 2: the loop alone
__global__ void barriers(int mode, int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const long long t0 = clock64();
  const unsigned long long n0 = globaltimer();
  for (int i = 0; i < iters; ++i) {
    if (mode == 0) cluster.sync();
    else if (mode == 1) __syncthreads();
    else asm volatile("" ::: "memory");
  }
  const long long t1 = clock64();
  const unsigned long long n1 = globaltimer();
  if (threadIdx.x == 0 && cluster.block_rank() == 0) {
    g_cycles = (t1 - t0) / iters;
    g_ns = (n1 - n0) / iters;
  }
  cluster.sync();
}

__global__ void grid_barriers(int iters) {
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  const long long t0 = clock64();
  const unsigned long long n0 = globaltimer();
  for (int i = 0; i < iters; ++i) grid.sync();
  const long long t1 = clock64();
  const unsigned long long n1 = globaltimer();
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    g_cycles = (t1 - t0) / iters;
    g_ns = (n1 - n0) / iters;
  }
}

__global__ void empty() {}

static cudaLaunchConfig_t config(int C, int threads, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static int read_back(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_cycles, sizeof(*out));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out + 1, g_ns, sizeof(*out));
  return static_cast<int>(err);
}

// out: cycles and ns per barrier (mode as `barriers`; mode 3: grid.sync()
// over C blocks, a cooperative launch)
extern "C" int cycles(int mode, int C, int threads, int iters, unsigned long long* out) {
  if (mode == 3) {
    void* params[] = {&iters};
    for (int i = 0; i < 2; ++i) {
      cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_barriers),
                                                    dim3(C), dim3(threads), params, 0, 0);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return read_back(out);
  }
  cudaFuncSetAttribute(barriers, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(C, threads, &attr);
  for (int i = 0; i < 2; ++i) cudaLaunchKernelEx(&cfg, barriers, mode, iters);
  return read_back(out);
}

extern "C" float launch_ms(int C, int threads, int n) {
  cudaFuncSetAttribute(empty, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(C, threads, &attr);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 10; ++i) cudaLaunchKernelEx(&cfg, empty);
  cudaEventRecord(a);
  for (int i = 0; i < n; ++i) cudaLaunchKernelEx(&cfg, empty);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  return ms / n;
}
"""

MODES = {"cluster": 0, "block": 1, "loop": 2, "grid": 3}


@functools.cache
def library() -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "hopper_barriers.cu", out_dir / "hopper_barriers.so"
    src.write_text(SOURCE)
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.cycles.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.launch_ms.argtypes = [ctypes.c_int] * 3
    lib.launch_ms.restype = ctypes.c_float
    return lib


def barrier(kind: str, blocks: int, threads: int, iters: int = 4000) -> tuple[int, int]:
    """(cycles, ns) per barrier of ``kind`` ("cluster": a cluster of
    ``blocks`` CTAs; "block": __syncthreads() in such a cluster; "loop":
    the empty loop; "grid": grid.sync() over ``blocks`` co-resident
    blocks), each block of ``threads`` threads, averaged over ``iters``."""
    out = (ctypes.c_ulonglong * 2)()
    err = library().cycles(MODES[kind], blocks, threads, iters, out)
    if err:
        raise RuntimeError(f"CUDA error {err} timing a {kind} barrier at {blocks} x {threads}")
    return out[0], out[1]


def barrier_ns(kind: str, blocks: int, threads: int) -> int:
    """Nanoseconds per barrier, as :func:`barrier` measures it."""
    return barrier(kind, blocks, threads)[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hopper_barriers: no CUDA device", file=sys.stderr)
        return 1
    for threads in (256, 512, 1024):
        for C in (1, 10, 16):
            row = {"threads": threads, "cluster": C}
            for kind in ("cluster", "block", "loop"):
                row[f"{kind}_cycles"], row[f"{kind}_ns"] = barrier(kind, C, threads)
            row["launch_ms"] = library().launch_ms(C, threads, 500)
            print(json.dumps(row), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for per_sm in (1, 2):
        cyc, ns = barrier("grid", sms * per_sm, 512)
        print(json.dumps({"threads": 512, "grid_blocks": sms * per_sm, "grid_cycles": cyc,
                          "grid_ns": ns}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
