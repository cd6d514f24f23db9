// Backward of blockwise (flash) attention: dQ, dK and dV of the causal,
// sliding-window or bidirectional attention that flash_attention.cu
// computes, with grouped KV heads.
//
// The Pallas TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention/
// kernel.py:28) is forward only; the JAX model trains through autodiff of
// its plain `_sdpa` (src/repro/models/layers.py:52).  This is the port's
// backward for K4, behind `ops.py::flash_attention`'s autograd Function.
// For query head h of batch b, row i and key j inside the mask (the
// forward's: (not causal or j <= i) and (no window or j > i - window)),
// with hk = h / (Hq / Hk):
//   P[i,j]  = exp(scale * q_i . k_j - lse_i)       (lse from the forward)
//   delta_i = dO_i . O_i
//   dS[i,j] = P[i,j] * (dO_i . v_j - delta_i)
//   dQ_i   = scale * sum_j dS[i,j] k_j
//   dK_j   = scale * sum_{h in the group of hk} sum_i dS[i,j] q_i
//   dV_j   =         sum_{h in the group of hk} sum_i P[i,j] dO_i
// Everything is float32 inside; the gradients are written in the input type.
//
// No atomics, so two launches on the same inputs give the same bits.  Two
// kernels, in stream order:
//   1. `dq_kernel`: a block per (b, h, 64 query rows) computes delta for
//      its rows (written for the next kernel), then walks the KV tiles its
//      rows can see, staged in shared memory 32 keys at a time, and owns
//      its rows' dQ;
//   2. `dkv_kernel`: a block per (b, hk, 64 keys) walks every query head of
//      the group and every query tile that can see its keys, staged 32 rows
//      at a time with their lse and delta, and owns its keys' dK and dV:
//      the sum over the group runs in a fixed order.
// In both, a row (a query row, or a key) belongs to D / 32 neighbouring
// lanes, each holding 32 of its D columns in registers: the dot products
// q.k and dO.v are summed across those lanes with xor shuffles (the same
// bits in every lane), the accumulators stay in registers.  A staged row's
// 32-column slices are padded to 36 floats, so the D / 32 slices a warp
// reads at once fall on different banks.
//
// What bounds it on Hopper: 10 D FLOPs per unmasked pair (the recomputed
// Q K^T, dP = dO V^T, dV, dQ, dK), at granite-3-2b's training shape
// ([4, 32, 2048, 64] against [4, 8, 2048, 64], causal) 172 GFLOP against
// 84 MB in bf16: operations, 0.17 ms at the bf16 tensor cores' peak.  This
// first kernel computes on the float32 units (14 D FLOPs a pair: Q K^T and
// dO V^T are computed in both kernels) and reads its operands from shared
// memory for every product; moving the products onto the tensor cores is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

struct Strides {  // element strides of the batch, head and sequence axes
  long long b, h, s;
};

constexpr int kRows = 64;        // a block's own rows: query rows (dq) or keys (dk, dv)
constexpr int kTile = 32;        // rows of the other side staged per step
constexpr int kCols = 32;        // columns of D a lane owns
constexpr int kPad = kCols + 4;  // floats of a staged 32-column slice

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// this lane's 32 columns of a row in global memory, as float32 (zeros if !in)
template <typename T>
__device__ __forceinline__ void load_slice(const T* p, bool in, float (&x)[kCols]) {
#pragma unroll
  for (int i = 0; i < kCols; i += 8) {
    if (in) {
      load8(p + i, x + i);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[i + j] = 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_slice(T* p, const float (&x)[kCols], float mul) {
#pragma unroll
  for (int i = 0; i < kCols; i += 8) {
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = x[i + j] * mul;
    store8(p + i, y);
  }
}

// rows r0 .. r0 + kTile - 1 of a [S, D] operand (rows >= S as zeros) into
// shared memory as float32, laid out [kTile][D / 32][kPad]
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long stride, int r0,
                                      int S) {
  constexpr int kChunks = D / 8;  // 8-element chunks in a row
  for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int col = (i - r * kChunks) * 8;
    float x[8];
    if (r0 + r < S) {
      load8(src + (r0 + r) * stride + col, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
    store8(dst + (r * (D / kCols) + col / kCols) * kPad + col % kCols, x);
  }
}

__device__ __forceinline__ float dot_slice(const float (&a)[kCols], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kCols; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + i);
    s = fmaf(a[i], x.x, s);
    s = fmaf(a[i + 1], x.y, s);
    s = fmaf(a[i + 2], x.z, s);
    s = fmaf(a[i + 3], x.w, s);
  }
  return s;
}

__device__ __forceinline__ void axpy_slice(float a, const float* x, float (&y)[kCols]) {
#pragma unroll
  for (int i = 0; i < kCols; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    y[i] = fmaf(a, v.x, y[i]);
    y[i + 1] = fmaf(a, v.y, y[i + 1]);
    y[i + 2] = fmaf(a, v.z, y[i + 2]);
    y[i + 3] = fmaf(a, v.w, y[i + 3]);
  }
}

// the sum of a row's NS partial dot products, the same bits in each of its lanes
template <int NS>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < NS; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / kCols))
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ o, const T* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
              int Hq, int group, int S, Strides qs, Strides ks, Strides vs, Strides os,
              Strides dos, Strides dqs, float scale, int causal, int window) {
  constexpr int NS = D / kCols;
  __shared__ __align__(16) float k_s[kTile * NS * kPad];
  __shared__ __align__(16) float v_s[kTile * NS * kPad];

  const int c = threadIdx.x % NS;                     // this lane's column slice
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest rows first
  const int row = q0 + threadIdx.x / NS;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / group;
  const bool in = row < S;
  const int col = c * kCols;

  float qr[kCols], dor[kCols], acc[kCols];
  float delta_r;
  {
    float orow[kCols];
    load_slice(q + b * qs.b + h * qs.h + row * qs.s + col, in, qr);
    load_slice(dout + b * dos.b + h * dos.h + row * dos.s + col, in, dor);
    load_slice(o + b * os.b + h * os.h + row * os.s + col, in, orow);
    float part = 0.f;
#pragma unroll
    for (int d = 0; d < kCols; ++d) part = fmaf(dor[d], orow[d], part);
    delta_r = row_sum<NS>(part);
  }
  if (in && c == 0) delta[static_cast<long long>(bh) * S + row] = delta_r;
  const float lse_r = in ? lse[static_cast<long long>(bh) * S + row] : CUDART_INF_F;
#pragma unroll
  for (int d = 0; d < kCols; ++d) acc[d] = 0.f;

  // the keys any row of the block may see, and this row's own range
  const int q_last = min(q0 + kRows, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kTile * kTile : 0;
  const int lo = window > 0 ? max(0, row - window + 1) : 0;
  const int hi = causal ? min(S, row + 1) : S;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int j0 = k_begin; j0 < k_end; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage<T, D>(k_s, kb, ks.s, j0, S);
    stage<T, D>(v_s, vb, vs.s, j0, S);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      const float* kj = k_s + (j * NS + c) * kPad;
      const float s = row_sum<NS>(dot_slice(qr, kj));
      const float dp = row_sum<NS>(dot_slice(dor, v_s + (j * NS + c) * kPad));
      const int key = j0 + j;
      const float p = (in && key >= lo && key < hi) ? expf(s * scale - lse_r) : 0.f;
      axpy_slice(p * (dp - delta_r), kj, acc);
    }
  }
  if (in) store_slice(dq + b * dqs.b + h * dqs.h + row * dqs.s + col, acc, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / kCols))
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               int Hq, int Hk, int group, int S, Strides qs, Strides ks, Strides vs,
               Strides dos, Strides dks, Strides dvs, float scale, int causal, int window) {
  constexpr int NS = D / kCols;
  __shared__ __align__(16) float q_s[kTile * NS * kPad];
  __shared__ __align__(16) float do_s[kTile * NS * kPad];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int c = threadIdx.x % NS;
  const int k0 = blockIdx.x * kRows;  // causal: the first key tiles see the most rows
  const int key = k0 + threadIdx.x / NS;
  const int b = blockIdx.y / Hk;
  const int hk = blockIdx.y - b * Hk;
  const bool in = key < S;
  const int col = c * kCols;

  float kr[kCols], vr[kCols], dk_acc[kCols], dv_acc[kCols];
  load_slice(k + b * ks.b + hk * ks.h + key * ks.s + col, in, kr);
  load_slice(v + b * vs.b + hk * vs.h + key * vs.s + col, in, vr);
#pragma unroll
  for (int d = 0; d < kCols; ++d) dk_acc[d] = dv_acc[d] = 0.f;

  // the query rows that may see any key of the block
  const int k_last = min(k0 + kRows, S) - 1;
  const int i_begin = causal ? k0 : 0;
  const int i_end = window > 0 ? min(S, k_last + window) : S;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long bh = static_cast<long long>(b) * Hq + h;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    for (int i0 = i_begin; i0 < i_end; i0 += kTile) {
      __syncthreads();
      stage<T, D>(q_s, qb, qs.s, i0, S);
      stage<T, D>(do_s, dob, dos.s, i0, S);
      if (threadIdx.x < kTile) {
        const int i = i0 + threadIdx.x;
        lse_s[threadIdx.x] = i < S ? lse[bh * S + i] : CUDART_INF_F;
        delta_s[threadIdx.x] = i < S ? delta[bh * S + i] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        const float* qi = q_s + (i * NS + c) * kPad;
        const float* doi = do_s + (i * NS + c) * kPad;
        const float s = row_sum<NS>(dot_slice(kr, qi));
        const float dp = row_sum<NS>(dot_slice(vr, doi));
        const int qrow = i0 + i;
        const bool ok = in && qrow < S && (!causal || key <= qrow) &&
                        (window <= 0 || key > qrow - window);
        const float p = ok ? expf(s * scale - lse_s[i]) : 0.f;
        axpy_slice(p, doi, dv_acc);
        axpy_slice(p * (dp - delta_s[i]), qi, dk_acc);
      }
    }
  }
  if (in) {
    store_slice(dk + b * dks.b + hk * dks.h + key * dks.s + col, dk_acc, scale);
    store_slice(dv + b * dvs.b + hk * dvs.h + key * dvs.s + col, dv_acc, 1.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
           int Hk, int S, const Strides* st, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr int kThreads = kRows * (D / kCols);
  const int tiles = (S + kRows - 1) / kRows;
  dq_kernel<T, D><<<dim3(tiles, B * Hq), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      Hq, Hq / Hk, S, st[0], st[1], st[2], st[3], st[4], st[5], scale, causal, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<T, D><<<dim3(tiles, B * Hk), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Hq,
      Hk, Hq / Hk, S, st[0], st[1], st[2], st[4], st[6], st[7], scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq [B, Hq, S, D]; k, v, dk, dv [B, Hk, S, D], all float32
// (bf16 == 0) or all bfloat16 (bf16 == 1) on the current device, with unit
// stride along D, the given element strides (q, k, v, o, dout, dq, dk, dv;
// batch, head, sequence each) in whole 16 bytes, 16-byte aligned.  lse is
// the forward's contiguous float32 [B, Hq, S]; delta a contiguous float32
// [B, Hq, S] scratch.  D is 32, 64 or 128; window <= 0 means no window.
// Launches both kernels on `stream`; returns the first launch error
// (cudaErrorInvalidValue for a D it was not built for).
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Hq, int Hk, int S,
    int D, int bf16, const long long* strides, float scale, int causal, int window,
    void* stream) {
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define BWD_CASE(T, DD)                                                                    \
  if (D == DD)                                                                             \
    return launch<T, DD>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq, Hk, S, st, scale,     \
                         causal, window, s);
  if (bf16) {
    BWD_CASE(__nv_bfloat16, 32)
    BWD_CASE(__nv_bfloat16, 64)
    BWD_CASE(__nv_bfloat16, 128)
  } else {
    BWD_CASE(float, 32)
    BWD_CASE(float, 64)
    BWD_CASE(float, 128)
  }
#undef BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
