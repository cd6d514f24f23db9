// Blockwise online-softmax (flash) attention, causal and/or sliding-window
// masked, with grouped KV heads (GQA / MQA).
//
// Replaces the Pallas TPU kernel `_flash_kernel` (with
// `flash_attention_padded` and the wrapper `ops.py::flash_attention`) at
// src/repro/kernels/flash_attention/kernel.py:28, and computes the same
// function as its oracle, src/repro/kernels/flash_attention/ref.py.  For
// query head h of batch b and query row i, over the keys j with
//   (not causal or j <= i) and (no window or j > i - window):
//   out[b,h,i] = sum_j softmax_j(scale * q[b,h,i] . k[b,hk,j]) v[b,hk,j],
// hk = h / (Hq / Hk) (the reference's head-major `b // group` mapping).
// Logits, the running max m, the running sum l and the accumulator are
// float32 whatever the input type; the output is acc / max(l, 1e-30) cast
// to the input type, so a row with no valid key gives 0 (as ref.py does).
//
// What bounds it on Hopper: at the serving path's prefill (granite-3-2b,
// [4, 32, 2048, 64] queries against [4, 8, 2048, 64] keys, causal, bf16) it
// does 68.7 GFLOP against 84 MB of inputs and output: operations, 0.069 ms at
// the bf16 tensor cores' 989 TFLOP/s against 0.025 ms for the bytes.
//
// Design, simple first.  The TPU kernel walks a sequential grid over KV
// blocks with (m, l, acc) in VMEM scratch; here one block of kBQ threads
// owns kBQ query rows of one (b, h), one row per thread, and loops over KV
// tiles itself:
//   - the block's query tile is staged once in shared memory as float32;
//   - each KV tile of kBK keys is staged in shared memory as float32, every
//     thread reads the same key at a time (a broadcast, no bank conflicts);
//   - a thread keeps its row's (m, l) and its float32 accumulator of D
//     values in registers, and its tile of probabilities in shared memory;
//   - KV tiles outside the block's causal/window range are never loaded
//     (the reference iterates over them at zero contribution,
//     kernel.py:7-10), and within a tile a row multiplies only its valid
//     keys into the accumulator;
//   - blocks are issued longest rows first, so the causal tail is short.
// Every product is a float32 FMA outside the tensor cores: about 1/15 of the
// card's bf16 rate at best.  Left for later: the products on the tensor
// cores (`mma.sync`, then `wgmma` on 64-row warpgroup tiles), TMA loads of
// the KV tiles into a ring of shared-memory stages, and loads overlapped
// with the math (a producer warp and `mbarrier`s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 128;  // query rows per block: one per thread
constexpr int kBK = 32;   // keys per shared-memory tile

struct Strides {  // element strides of the batch, head and sequence axes
  long long b, h, s;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile (rows padded by 4 floats), k and v tiles, probabilities
  return sizeof(float) *
         (kBQ * (D + 4) + 2 * kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int Hq, int group, int S, Strides qs, Strides ks,
                           Strides vs, Strides os, float scale, int causal,
                           int window) {
  constexpr int QP = D + 4;  // a quarter-warp's float4 reads of 8 rows hit 32 banks
  constexpr int V4 = D / 4;  // float4 groups in a row
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBQ][QP]
  float* k_s = q_s + kBQ * QP;                   // [kBK][D]
  float* v_s = k_s + kBK * D;                    // [kBK][D]
  float* p_s = v_s + kBK * D;                    // [kBQ][kBK + 1]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = threadIdx.x; i < kBQ * V4; i += kBQ) {
    const int r = i / V4;
    const int c = (i - r * V4) * 4;
    store4(q_s + r * QP + c, q0 + r < S ? load4(qb + (q0 + r) * qs.s + c) : zero);
  }

  // keys any row of the block may see, and this thread's row's own range
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int row = q0 + threadIdx.x;
  const int lo = window > 0 ? max(0, row - window + 1) : 0;
  const int hi = causal ? min(S, row + 1) : S;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;
  const float* q_row = q_s + threadIdx.x * QP;
  float* p_row = p_s + threadIdx.x * (kBK + 1);

  for (int j0 = k_begin; j0 < k_end; j0 += kBK) {
    __syncthreads();  // the q tile is in; the previous KV tile is consumed
    for (int i = threadIdx.x; i < kBK * V4; i += kBQ) {
      const int r = i / V4;
      const int c = (i - r * V4) * 4;
      const bool in = j0 + r < S;
      store4(k_s + r * D + c, in ? load4(kb + (j0 + r) * ks.s + c) : zero);
      store4(v_s + r * D + c, in ? load4(vb + (j0 + r) * vs.s + c) : zero);
    }
    __syncthreads();
    const int t_lo = max(lo, j0) - j0;  // this row's valid columns of the tile
    const int t_hi = min(hi, j0 + kBK) - j0;
    if (row >= S || t_lo >= t_hi) continue;

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 a = load4(q_row + d);
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float4 kk = load4(k_s + j * D + d);
        s[j] = fmaf(a.x, kk.x, s[j]);
        s[j] = fmaf(a.y, kk.y, s[j]);
        s[j] = fmaf(a.z, kk.z, s[j]);
        s[j] = fmaf(a.w, kk.w, s[j]);
      }
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] *= scale;
      if (j >= t_lo && j < t_hi) m_new = fmaxf(m_new, s[j]);
    }
    const float corr = expf(m - m_new);  // exp(-inf) = 0 before the first key
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = (j >= t_lo && j < t_hi) ? expf(s[j] - m_new) : 0.f;
      p_row[j] = p;
      p_sum += p;
    }
    l = l * corr + p_sum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
    for (int j = t_lo; j < t_hi; ++j) {
      const float p = p_row[j];
      const float* v_row = v_s + j * D;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = load4(v_row + d);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
  }

  if (row >= S) return;
  const float denom = fmaxf(l, 1e-30f);
  T* o_row = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
  for (int d = 0; d < D; d += 4)
    store4(o_row + d, make_float4(acc[d] / denom, acc[d + 1] / denom,
                                  acc[d + 2] / denom, acc[d + 3] / denom));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hk, int S, Strides qs, Strides ks, Strides vs,
           Strides os, float scale, int causal, int window,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  kernel<<<grid, kBQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hq / Hk, S, qs, ks, vs,
      os, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, S, D], k and v [B, Hk, S, D], o [B, Hq, S, D], all float32
// (bf16 == 0) or all bfloat16 (bf16 == 1) on the current device, with unit
// stride along D and the given element strides (multiples of 4) of the
// batch, head and sequence axes, 16-byte aligned.  D is 32, 64 or 128;
// window <= 0 means no window.  Launches on `stream`; returns the launch's
// cudaError_t (cudaErrorInvalidValue for a D or type it was not built for).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hk, int S, int D, int bf16, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int window,
    void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(T, DD)                                                    \
  if (D == DD)                                                               \
    return launch<T, DD>(q, k, v, o, B, Hq, Hk, S, qs, ks, vs, os, scale,    \
                         causal, window, st);
  if (bf16) {
    FLASH_CASE(__nv_bfloat16, 32)
    FLASH_CASE(__nv_bfloat16, 64)
    FLASH_CASE(__nv_bfloat16, 128)
  } else {
    FLASH_CASE(float, 32)
    FLASH_CASE(float, 64)
    FLASH_CASE(float, 128)
  }
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
