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
// The gradients are written in the input type.  No atomics: every sum runs
// in one block in one fixed order, so two launches on the same inputs give
// the same bits.  `flash_attention_backward_launch` picks the path by type.
//
// What bounds it on Hopper: 10 D FLOPs per unmasked pair (the recomputed
// Q K^T, dP = dO V^T, dV, dQ, dK), at granite-3-2b's training shape
// ([4, 32, 2048, 64] against [4, 8, 2048, 64], causal) 172 GFLOP against
// 84 MB in bf16: operations, 0.17 ms at the bf16 tensor cores' 989 TFLOP/s.
// Without atomics dQ is a kernel of its own, which recomputes Q K^T and
// dO V^T: 14 D FLOPs a pair are executed, 241 GFLOP at that shape.  There
// a bf16 call takes 0.67 ms on an NVIDIA H100 80GB HBM3 at 700 W
// (`dkv_kernel` 0.37, `dq_kernel` 0.28, the pre-pass 0.03): 37 % of the
// tensor cores' peak over the executed FLOPs, 1.1x the time of PyTorch's
// SDPA backward, which computes S and dP once and adds dQ with atomics.
//
// bf16 (training): three kernels on the stream, in `tc`:
//   1. `delta_kernel`, a pre-pass: delta = rowsum(dO * O) in float32 and
//      lse * log2(e), both into [B * Hq, S_pad] vectors (S rounded up to
//      128; +inf and 0 past S, so P is 0 there), which the next two read
//      by whole tiles;
//   2. `dq_kernel`, warp-specialised like the forward: a block of 384
//      threads owns 128 query rows of one (b, h).  Warpgroup 2 is the
//      producer: after `setmaxnreg` gives its registers away, one thread
//      loads the block's Q and dO once and then streams K and V tiles of 64
//      keys by TMA into an `mbarrier` ring (4 stages, 3 at D = 128).
//      Warpgroups 0 and 1 each own 64 rows: S = Q K^T and dP = dO V^T are
//      `wgmma` m64n64k16 with both operands K-major in shared memory (all
//      rows are D-contiguous: nothing is transposed); P = 2^(S scale log2(e)
//      - lse log2(e)) on the special-function unit, the element mask only
//      on tiles that cross the diagonal, the window's edge or S; dS = P (dP
//      - delta), made two neighbouring columns at a time and packed to bf16
//      as they are made, so that few float32 values are live beside the
//      accumulators; dQ += dS K is `wgmma` with dS from registers (the
//      accumulator layout of 16 keys is the A fragment) and K MN-major
//      through the transpose bit;
//   3. `dkv_kernel`: a block owns 128 keys of one (b, hk), loaded once;
//      the producer streams the Q and dO tiles of 64 rows (with their
//      lse2 and delta, by bulk copies) of every query head of the group
//      and every query tile that can see the keys, in that order;
//      warpgroup w owns 64 keys: S^T = K Q^T and dP^T = V dO^T
//      (both operands K-major), P^T and dS^T as above with lse2 and delta
//      along the columns, then dV += P^T dO and dK += dS^T Q with A from
//      registers and B MN-major.  At D = 128, dK and dV hold 128 registers
//      a thread: made all at once and packed after, P^T and dS^T spill.
// Each warpgroup issues its products and waits for them; the two consumer
// warpgroups fill the tensor cores in turn (issuing a tile's products
// beside the previous tile's within a warpgroup, as the forward does, or
// committing S and dP apart, measured slower).  Streamed tiles are 64 rows:
// at 128 (m64n128 products) `dkv_kernel` spills at D = 64, and
// `dq_kernel` gains 2 % at D = 64 only (on the same card).
// In both, the 4-D tensor maps over (D, S, H, B) carry the operands'
// strides, so the layers' [B, S, H, D] views are read in place (rows past S
// arrive as zeros); the accumulators stay float32 in registers; tiles
// outside a block's causal/window range are never loaded, and a warpgroup
// skips the math of a tile outside its own rows' range; the epilogue stages
// the warpgroup's gradient as bf16 over its own rows of its resident tile
// and writes it with 16-byte stores that never touch rows >= S.
// Numerics: P and dS are rounded to bf16 before the products, as
// FlashAttention's backward does; everything else is float32.  Held to the
// bf16 bar, 2e-2 of each gradient's largest |ref|.
//
// float32 (the 1e-4 bar, which TF32 on the tensor cores cannot meet): two
// SIMT kernels in `simt`, on the CUDA cores:
//   1. `dq_kernel`: a block per (b, h, 64 query rows) computes delta for
//      its rows (written for the next kernel), then walks the KV tiles its
//      rows can see, staged in shared memory 32 keys at a time, and owns
//      its rows' dQ;
//   2. `dkv_kernel`: a block per (b, hk, 64 keys) walks every query head of
//      the group and every query tile that can see its keys, staged 32 rows
//      at a time with their lse and delta, and owns its keys' dK and dV.
// In both, a row (a query row, or a key) belongs to D / 32 neighbouring
// lanes, each holding 32 of its D columns in registers: the dot products
// q.k and dO.v are summed across those lanes with xor shuffles (the same
// bits in every lane), the accumulators stay in registers.  A staged row's
// 32-column slices are padded to 36 floats, so the D / 32 slices a warp
// reads at once fall on different banks.  Every product is a float32 FMA
// that reads an operand from shared memory: bound by shared memory's
// bandwidth, not by the FMA rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

struct Strides {  // element strides of the batch, head and sequence axes
  long long b, h, s;
};

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

// ------------------------------------------------------------------------
// float32: SIMT kernels, float32 FMAs on the CUDA cores
// ------------------------------------------------------------------------
namespace simt {

constexpr int kRows = 64;        // a block's own rows: query rows (dq) or keys (dk, dv)
constexpr int kTile = 32;        // rows of the other side staged per step
constexpr int kCols = 32;        // columns of D a lane owns
constexpr int kPad = kCols + 4;  // floats of a staged 32-column slice

__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// this lane's 32 columns of a row in global memory, as float32 (zeros if !in)
__device__ __forceinline__ void load_slice(const float* p, bool in, float (&x)[kCols]) {
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

__device__ __forceinline__ void store_slice(float* p, const float (&x)[kCols], float mul) {
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
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, long long stride, int r0,
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

template <int D>
__global__ void __launch_bounds__(kRows * (D / kCols))
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ o, const float* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq,
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
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int j0 = k_begin; j0 < k_end; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage<D>(k_s, kb, ks.s, j0, S);
    stage<D>(v_s, vb, vs.s, j0, S);
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

template <int D>
__global__ void __launch_bounds__(kRows * (D / kCols))
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
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
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dout + b * dos.b + h * dos.h;
    for (int i0 = i_begin; i0 < i_end; i0 += kTile) {
      __syncthreads();
      stage<D>(q_s, qb, qs.s, i0, S);
      stage<D>(do_s, dob, dos.s, i0, S);
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

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
           int Hk, int S, const Strides* st, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr int kThreads = kRows * (D / kCols);
  const int tiles = (S + kRows - 1) / kRows;
  dq_kernel<D><<<dim3(tiles, B * Hq), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), Hq, Hq / Hk, S, st[0], st[1], st[2], st[3], st[4], st[5], scale,
      causal, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<D><<<dim3(tiles, B * Hk), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Hq, Hk, Hq / Hk, S, st[0], st[1], st[2], st[4], st[6], st[7],
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ------------------------------------------------------------------------
// bf16: warp-specialised tensor-core kernels (wgmma, TMA ring, mbarriers)
// ------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kRows = 128;     // a block's own rows: keys (dkv) or query rows (dq)
constexpr int kTile = 64;      // rows of the other side a stage of the ring holds
constexpr int kThreads = 384;  // warpgroups 0, 1 consume (64 own rows each); 2 loads
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kBoxCols = D < 64 ? D : 64;  // a box row is at most 128 bytes
  static constexpr int kBoxes = D / kBoxCols;       // boxes across D (2 at D = 128)
  static constexpr int kRowBytes = kBoxCols * 2;    // = the swizzle span, 64 or 128
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma descriptor: B128, B64
  static constexpr int kN = D < 64 ? D : 64;        // width of a product into D columns
  static constexpr int kHalves = D / kN;            // such products per 16 rows of depth
  static constexpr int kOwnBytes = kRows * D * 2;   // a block's own 128 rows of one operand
  static constexpr int kTileBytes = kTile * D * 2;  // a stage's 64 rows of one operand
  static constexpr int kStages = D == 128 ? 3 : 4;
  // shared memory from a 1024-aligned base: the two own tiles, the ring's
  // stages of two tiles, each stage's lse2 and delta (dkv), the barriers
  static constexpr int kRing = 2 * kOwnBytes;
  static constexpr int kVec = kRing + kStages * 2 * kTileBytes;
  static constexpr int kBar = kVec + kStages * 2 * kTile * 4;
  static constexpr int kSmem = 1024 + kBar + 8 * (1 + 2 * kStages);
};
static_assert(Cfg<32>::kSmem <= 232448 && Cfg<64>::kSmem <= 232448 && Cfg<128>::kSmem <= 232448,
              "a block's shared memory on Hopper");

// The block's shared memory: tiles of `rows` rows laid out as the TMA boxes
// put them, D in kBoxes column boxes of kBoxCols, each box `rows` swizzled
// rows of kRowBytes.
template <int D>
struct Smem {
  using C = Cfg<D>;
  uint8_t* ptr;
  uint32_t base;
  __device__ explicit Smem(uint8_t* raw)
      : ptr(reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                       ~uintptr_t(1023))),
        base(smem_u32(ptr)) {}
  __device__ uint32_t own(int i) const { return base + i * C::kOwnBytes; }
  __device__ uint32_t stage(int st, int i) const {
    return base + C::kRing + (2 * st + i) * C::kTileBytes;
  }
  __device__ const float* vec(int st) const {  // lse2[kTile], then delta[kTile]
    return reinterpret_cast<const float*>(ptr + C::kVec + st * 2 * kTile * 4);
  }
  __device__ uint32_t own_full() const { return base + C::kBar; }
  __device__ uint32_t full(int st) const { return base + C::kBar + 8 * (1 + st); }
  __device__ uint32_t empty(int st) const { return base + C::kBar + 8 * (1 + C::kStages + st); }
};

// descriptor of the 64 x 16 (K-major) slice at row r0, depth 16 kk of a tile of `rows` rows
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0, int kk) {
  using C = Cfg<D>;
  return make_desc(tile + kk * 16 / C::kBoxCols * rows * C::kRowBytes + r0 * C::kRowBytes +
                       (kk * 16 % C::kBoxCols) * 2,
                   8 * C::kRowBytes, C::kLayout);
}

// descriptor of the 16 x kN (MN-major, through the transpose bit) slice at
// rows 16 kk, columns kN x of a tile of `rows` rows
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk, int x) {
  using C = Cfg<D>;
  return make_desc(tile + x * rows * C::kRowBytes + kk * 16 * C::kRowBytes, 8 * C::kRowBytes,
                   C::kLayout);
}

// the 64-row boxes of a `rows`-row tile at sequence row r0 that start
// before S: only those are loaded (a warpgroup whose rows all lie past S
// reads none of its tile)
__device__ __forceinline__ int boxes_in(int rows, int r0, int S) {
  return min(rows / kTile, (S - r0 + kTile - 1) / kTile);
}

// the `rows`-row tile of a (D, S, H, B) map at sequence row r0 into `dst`,
// by 64-row boxes; rows past S arrive as zeros
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, int rows, const CUtensorMap* map, int r0,
                                          int h, int b, int S, uint32_t bar) {
  using C = Cfg<D>;
  for (int c = 0; c < boxes_in(rows, r0, S); ++c)
    for (int x = 0; x < C::kBoxes; ++x)
      tma_load(dst + x * rows * C::kRowBytes + c * kTile * C::kRowBytes, map, x * C::kBoxCols,
               r0 + c * kTile, h, b, bar);
}

// a warpgroup's 64 own rows of the D-column accumulators `acc` (times
// `mul`) as bf16 over its own rows of the tile at byte offset `tile`
// (16-byte chunks XOR-swizzled by row), then 16-byte stores of the rows < S
template <int D>
__device__ __forceinline__ void store_rows(const Smem<D>& sm, int tile, int wg, int tid,
                                           const float (&acc)[Cfg<D>::kHalves][Cfg<D>::kN / 2],
                                           float mul, __nv_bfloat16* out, long long stride,
                                           int r_lo, int S) {
  using C = Cfg<D>;
  constexpr int kChunks = C::kBoxCols / 8;  // 16-byte chunks in a box row
  constexpr int kSwz = kChunks < 8 ? kChunks : 8;
  const int lane = tid % 32;
  auto at = [&](int lr, int col) {          // byte address of (own row lr, column col)
    return sm.ptr + tile + col / C::kBoxCols * kRows * C::kRowBytes +
           (64 * wg + lr) * C::kRowBytes + ((col % C::kBoxCols / 8) ^ (lr % kSwz)) * 16 +
           col % 8 * 2;
  };
  const int lr0 = 16 * (tid / 32) + lane / 4;
#pragma unroll
  for (int x = 0; x < C::kHalves; ++x)
#pragma unroll
    for (int i = 0; i < C::kN / 2; i += 2) {
      const int col = x * C::kN + 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(at(lr0 + 8 * ((i % 4) / 2), col)) =
          pack_bf16(acc[x][i] * mul, acc[x][i + 1] * mul);
    }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
#pragma unroll
  for (int it = 0; it < 64 * (D / 8) / 128; ++it) {
    const int idx = it * 128 + tid;
    const int lr = idx / (D / 8);
    const int col = idx % (D / 8) * 8;
    if (r_lo + lr < S)
      *reinterpret_cast<uint4*>(out + (r_lo + lr) * stride + col) =
          *reinterpret_cast<const uint4*>(at(lr, col));
  }
}

// S or S^T (64 own rows x kTile) from two K-major tiles in shared memory:
// own rows r0.. of `a` (kRows rows) against the kTile rows of `b`
template <int D>
__device__ __forceinline__ void issue_ss(float (&d)[kTile / 2], uint32_t a, int r0, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(d, desc_k<D>(a, kRows, r0, kk), desc_k<D>(b, kTile, 0, kk), kk > 0);
}

// acc += A B: A (64 x kTile, bf16 fragments in registers), B the kTile x D
// stage tile at `b`, MN-major
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[Cfg<D>::kHalves][Cfg<D>::kN / 2],
                                         const uint32_t (&a)[kTile / 16][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int x = 0; x < Cfg<D>::kHalves; ++x) wgmma_rs(acc[x], a[kk], desc_mn<D>(b, kTile, kk, x));
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[Cfg<D>::kHalves][Cfg<D>::kN / 2]) {
#pragma unroll
  for (int x = 0; x < Cfg<D>::kHalves; ++x)
#pragma unroll
    for (int i = 0; i < Cfg<D>::kN / 2; ++i) acc[x][i] = 0.f;
}

template <int D>
__device__ __forceinline__ void fence_acc(float (&acc)[Cfg<D>::kHalves][Cfg<D>::kN / 2]) {
#pragma unroll
  for (int x = 0; x < Cfg<D>::kHalves; ++x) fence_regs(acc[x]);
}

// Pre-pass: each padded row r = bh * S_pad + i of the two [B * Hq, S_pad]
// float32 vectors the kernels stream: lse2 = lse * log2(e) (+inf past S,
// so P is 0 there) and delta = rowsum(dO * O) in float32 (0 past S).
// D / 8 neighbouring lanes share a row, 8 columns each.
template <int D>
__global__ void __launch_bounds__(256)
    delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ lse2,
                 float* __restrict__ delta, int Hq, int S, int S_pad, long long n_rows,
                 Strides os, Strides dos) {
  constexpr int L = D / 8;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long r = idx / L;
  const int c = static_cast<int>(idx % L) * 8;
  const long long bh = r / S_pad;
  const int i = static_cast<int>(r - bh * S_pad);
  const bool in = r < n_rows && i < S;
  const int b = static_cast<int>(bh / Hq);
  const int h = static_cast<int>(bh - static_cast<long long>(b) * Hq);
  float part = 0.f;
  if (in) {
    float x[8], y[8];
    load8(dout + b * dos.b + h * dos.h + i * dos.s + c, x);
    load8(o + b * os.b + h * os.h + i * os.s + c, y);
#pragma unroll
    for (int j = 0; j < 8; ++j) part = fmaf(x[j], y[j], part);
  }
#pragma unroll
  for (int m = 1; m < L; m <<= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
  if (c == 0 && r < n_rows) {
    delta[r] = in ? part : 0.f;
    lse2[r] = in ? lse[bh * S + i] * kLog2e : CUDART_INF_F;
  }
}

// dK and dV of 128 keys of one (b, hk): warpgroup 2 loads the block's K and
// V once, then streams every query tile of every head of the group that can
// see the keys (Q, dO, their lse2 and delta) through the ring; warpgroups 0
// and 1 each own 64 keys and accumulate over the tiles in one fixed order.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map,
               const float* __restrict__ lse2, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Hq, int group,
               int S, int S_pad, Strides dks, Strides dvs, float scale, float scale_log2,
               int causal, int window) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  const int Hk = Hq / group;
  const int b = blockIdx.x / Hk;
  const int hk = blockIdx.x - b * Hk;
  const int k0 = blockIdx.y * kRows;  // causal: the first key tiles see the most rows
  // the query rows that may see any key of the block, in whole tiles
  const int k_last = min(k0 + kRows, S) - 1;
  const int i_begin = causal ? k0 : 0;
  const int i_end = window > 0 ? min(S, k_last + window) : S;
  const int n_t = (i_end - i_begin + kTile - 1) / kTile;
  const int n_u = group * n_t;  // (head, query tile) in the order g-major

  if (threadIdx.x == 0) {
    mbar_init(sm.own_full(), 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), 2 * 128);  // every consumer thread releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(sm.own_full(), 2 * boxes_in(kRows, k0, S) * C::kTileBytes);
      load_tile<D>(sm.own(0), kRows, &k_map, k0, hk, b, S, sm.own_full());
      load_tile<D>(sm.own(1), kRows, &v_map, k0, hk, b, S, sm.own_full());
      for (int u = 0; u < n_u; ++u) {
        const int st = u % C::kStages;
        const int h = hk * group + u / n_t;
        const int i0 = i_begin + (u % n_t) * kTile;
        mbar_wait(sm.empty(st), ((u / C::kStages) & 1) ^ 1);
        mbar_expect_tx(sm.full(st), 2 * C::kTileBytes + 2 * kTile * 4);
        load_tile<D>(sm.stage(st, 0), kTile, &q_map, i0, h, b, S, sm.full(st));
        load_tile<D>(sm.stage(st, 1), kTile, &do_map, i0, h, b, S, sm.full(st));
        const long long row = (static_cast<long long>(b) * Hq + h) * S_pad + i0;
        const uint32_t vec = smem_u32(sm.vec(st));
        bulk_load(vec, lse2 + row, kTile * 4, sm.full(st));
        bulk_load(vec + kTile * 4, delta + row, kTile * 4, sm.full(st));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x - wg * 128;
    const int lane = tid % 32;
    const int c_lo = k0 + 64 * wg;                       // the warpgroup's keys
    const int c_hi = min(c_lo + 63, S - 1);
    const int key0 = c_lo + 16 * (tid / 32) + lane / 4;  // this thread's keys: key0, key0 + 8
    const int col0 = 2 * (lane % 4);                     // and queries col0, col0 + 1 of each 8
    auto mine = [&](int i0) {  // can a query of the tile see a key of the warpgroup?
      return c_lo < S && (!causal || i0 + kTile - 1 >= c_lo) &&
             (window <= 0 || i0 < c_hi + window);
    };
    auto edge = [&](int i0) {  // does the tile cross the diagonal, the window or S?
      return (causal && c_lo + 63 > i0) || (window > 0 && c_lo <= i0 + kTile - 1 - window) ||
             i0 + kTile > S;
    };
    float dk_acc[C::kHalves][C::kN / 2], dv_acc[C::kHalves][C::kN / 2];
    zero<D>(dk_acc);
    zero<D>(dv_acc);
    float s[kTile / 2], dp[kTile / 2];
    uint32_t p[kTile / 16][4], ds[kTile / 16][4];
    mbar_wait(sm.own_full(), 0);
    for (int u = 0; u < n_u; ++u) {
      const int st = u % C::kStages;
      const int i0 = i_begin + (u % n_t) * kTile;
      mbar_wait(sm.full(st), (u / C::kStages) & 1);
      if (!mine(i0)) {
        mbar_arrive(sm.empty(st));
        continue;
      }
      // S^T = K Q^T and dP^T = V dO^T, K-major operands
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_ss<D>(s, sm.own(0), 64 * wg, sm.stage(st, 0));
      issue_ss<D>(dp, sm.own(1), 64 * wg, sm.stage(st, 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // P^T = 2^(S^T scale log2(e) - lse2), dS^T = P^T (dP^T - delta), two
      // neighbouring queries at a time, packed to bf16 as they are made
      const float* lv = sm.vec(st);
      const bool e = edge(i0);
#pragma unroll
      for (int i = 0; i < kTile / 2; i += 2) {
        const int lc = 8 * (i / 4) + col0;  // the queries i0 + lc, + 1
        const float2 lse_p = *reinterpret_cast<const float2*>(lv + lc);
        const float2 delta_p = *reinterpret_cast<const float2*>(lv + kTile + lc);
        float p0 = ex2(fmaf(s[i], scale_log2, -lse_p.x));
        float p1 = ex2(fmaf(s[i + 1], scale_log2, -lse_p.y));
        if (e) {
          const int key = key0 + 8 * ((i % 4) / 2);
          auto ok = [&](int qr) {
            return qr < S && (!causal || key <= qr) && (window <= 0 || key > qr - window);
          };
          p0 = ok(i0 + lc) ? p0 : 0.f;
          p1 = ok(i0 + lc + 1) ? p1 : 0.f;
        }
        p[i / 8][i % 8 / 2] = pack_bf16(p0, p1);
        ds[i / 8][i % 8 / 2] = pack_bf16(p0 * (dp[i] - delta_p.x), p1 * (dp[i + 1] - delta_p.y));
      }
      // dV += P^T dO, dK += dS^T Q: A from registers, B MN-major
      fence_acc<D>(dv_acc);
      fence_acc<D>(dk_acc);
      wgmma_fence();
      issue_rs<D>(dv_acc, p, sm.stage(st, 1));
      issue_rs<D>(dk_acc, ds, sm.stage(st, 0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<D>(dv_acc);
      fence_acc<D>(dk_acc);
      mbar_arrive(sm.empty(st));
    }
    // epilogue: the warpgroup's own rows of the K and V tiles take dK scale and dV
    const long long bk = static_cast<long long>(b) * dks.b + hk * dks.h;
    const long long bv = static_cast<long long>(b) * dvs.b + hk * dvs.h;
    store_rows<D>(sm, 0, wg, tid, dk_acc, scale, dk + bk, dks.s, c_lo, S);
    store_rows<D>(sm, C::kOwnBytes, wg, tid, dv_acc, 1.f, dv + bv, dvs.s, c_lo, S);
  }
}

// dQ of 128 query rows of one (b, h): warpgroup 2 loads the block's Q and dO
// once, then streams the K and V tiles its rows can see through the ring;
// warpgroups 0 and 1 each own 64 rows.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap do_map,
              const float* __restrict__ lse2, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int Hq, int group, int S, int S_pad, Strides dqs,
              float scale, float scale_log2, int causal, int window) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x - b * Hq;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest rows first
  // the keys any row of the block may see, in whole tiles
  const int k_end = causal ? min(q0 + kRows, S) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kTile * kTile : 0;
  const int n_tiles = (k_end - k_begin + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(sm.own_full(), 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(sm.own_full(), 2 * boxes_in(kRows, q0, S) * C::kTileBytes);
      load_tile<D>(sm.own(0), kRows, &q_map, q0, h, b, S, sm.own_full());
      load_tile<D>(sm.own(1), kRows, &do_map, q0, h, b, S, sm.own_full());
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % C::kStages;
        const int j0 = k_begin + t * kTile;
        mbar_wait(sm.empty(st), ((t / C::kStages) & 1) ^ 1);
        mbar_expect_tx(sm.full(st), 2 * C::kTileBytes);
        load_tile<D>(sm.stage(st, 0), kTile, &k_map, j0, hk, b, S, sm.full(st));
        load_tile<D>(sm.stage(st, 1), kTile, &v_map, j0, hk, b, S, sm.full(st));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x - wg * 128;
    const int lane = tid % 32;
    const int r_lo = q0 + 64 * wg;                       // the warpgroup's rows
    const int r_hi = min(r_lo + 63, S - 1);
    const int row0 = r_lo + 16 * (tid / 32) + lane / 4;  // this thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane % 4);                     // and keys col0, col0 + 1 of each 8
    // the warpgroup's own tiles t_first..t_last (none if all its rows are >= S)
    const int key_lo = window > 0 ? max(0, r_lo - window + 1) : 0;
    const int key_hi = causal ? r_hi + 1 : S;
    const int t_first = r_lo < S ? (key_lo - k_begin) / kTile : n_tiles;
    const int t_last = r_lo < S ? min(n_tiles - 1, (key_hi - 1 - k_begin) / kTile) : n_tiles - 1;
    auto edge = [&](int j0) {  // does the tile cross the diagonal, the window or S?
      return (causal && j0 + kTile - 1 > r_lo) || (window > 0 && j0 < r_hi - window + 1) ||
             j0 + kTile > S;
    };
    const long long bh = static_cast<long long>(blockIdx.x) * S_pad;
    const float l2[2] = {lse2[bh + row0], lse2[bh + row0 + 8]};
    const float dl[2] = {delta[bh + row0], delta[bh + row0 + 8]};
    float dq_acc[C::kHalves][C::kN / 2];
    zero<D>(dq_acc);
    float s[kTile / 2], dp[kTile / 2];
    uint32_t ds[kTile / 16][4];
    mbar_wait(sm.own_full(), 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % C::kStages;
      const int j0 = k_begin + t * kTile;
      mbar_wait(sm.full(st), (t / C::kStages) & 1);
      if (t < t_first || t > t_last) {
        mbar_arrive(sm.empty(st));
        continue;
      }
      // S = Q K^T and dP = dO V^T, K-major operands
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_ss<D>(s, sm.own(0), 64 * wg, sm.stage(st, 0));
      issue_ss<D>(dp, sm.own(1), 64 * wg, sm.stage(st, 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // P = 2^(S scale log2(e) - lse2), dS = P (dP - delta), two
      // neighbouring keys at a time, packed to bf16 as they are made
      const bool e = edge(j0);
#pragma unroll
      for (int i = 0; i < kTile / 2; i += 2) {
        const int rr = (i % 4) / 2;
        float p0 = ex2(fmaf(s[i], scale_log2, -l2[rr]));
        float p1 = ex2(fmaf(s[i + 1], scale_log2, -l2[rr]));
        if (e) {
          const int row = row0 + 8 * rr;
          auto ok = [&](int col) {
            return col < S && (!causal || col <= row) && (window <= 0 || col > row - window);
          };
          const int col = j0 + 8 * (i / 4) + col0;
          p0 = ok(col) ? p0 : 0.f;
          p1 = ok(col + 1) ? p1 : 0.f;
        }
        ds[i / 8][i % 8 / 2] = pack_bf16(p0 * (dp[i] - dl[rr]), p1 * (dp[i + 1] - dl[rr]));
      }
      // dQ += dS K: dS from registers, K MN-major
      fence_acc<D>(dq_acc);
      wgmma_fence();
      issue_rs<D>(dq_acc, ds, sm.stage(st, 0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<D>(dq_acc);
      mbar_arrive(sm.empty(st));
    }
    // epilogue: the warpgroup's own rows of the Q tile take dQ scale
    store_rows<D>(sm, 0, wg, tid, dq_acc, scale,
                  dq + static_cast<long long>(b) * dqs.b + h * dqs.h, dqs.s, r_lo, S);
  }
}

// (D, S, H, B) bf16 map with the operand's element strides, boxes of
// kBoxCols x kTile rows, swizzled to the box row's width
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int S, int H, int B, Strides st) {
  using C = Cfg<D>;
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st.s) * 2, cuuint64_t(st.h) * 2,
                                 cuuint64_t(st.b) * 2};
  const cuuint32_t box[4] = {cuuint32_t(C::kBoxCols), cuuint32_t(kTile), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the rows of lse2 and delta: S rounded up to whole blocks of kRows
inline int padded(int S) { return (S + kRows - 1) / kRows * kRows; }

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int Hq,
           int Hk, int S, const Strides* st, float scale, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode<D>(&q_map, q, S, Hq, B, st[0]) || !encode<D>(&k_map, k, S, Hk, B, st[1]) ||
      !encode<D>(&v_map, v, S, Hk, B, st[2]) || !encode<D>(&do_map, dout, S, Hq, B, st[4]))
    return static_cast<int>(cudaErrorInvalidValue);
  const int S_pad = padded(S);
  const long long n_rows = static_cast<long long>(B) * Hq * S_pad;
  float* lse2 = scratch;
  float* delta = scratch + n_rows;
  const long long threads = n_rows * (D / 8);
  delta_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, lse2,
      delta, Hq, S, S_pad, n_rows, st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = Cfg<D>::kSmem;
  const float scale_log2 = scale * kLog2e;
  err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<D><<<dim3(B * Hq, S_pad / kRows), kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse2, delta, static_cast<__nv_bfloat16*>(dq), Hq, Hq / Hk,
      S, S_pad, st[5], scale, scale_log2, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<D><<<dim3(B * Hk, S_pad / kRows), kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Hq, Hq / Hk, S, S_pad, st[6], st[7], scale, scale_log2,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q, o, dout, dq [B, Hq, S, D]; k, v, dk, dv [B, Hk, S, D], all float32
// (bf16 == 0) or all bfloat16 (bf16 == 1) on the current device, with unit
// stride along D, the given element strides (q, k, v, o, dout, dq, dk, dv;
// batch, head, sequence each) in whole 16 bytes, 16-byte aligned.  lse is
// the forward's contiguous float32 [B, Hq, S].  `scratch` is contiguous
// float32, 16-byte aligned: [B, Hq, S] for float32 (delta), and
// 2 x [B, Hq, S rounded up to 128] for bf16 (lse2, delta).  D is 32, 64 or
// 128; window <= 0 means no window.  Launches the kernels on `stream` (two
// for float32, three for bf16); returns the first launch error
// (cudaErrorInvalidValue for a D it was not built for, or operands the
// tensor maps refuse).
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* scratch, void* dq, void* dk, void* dv, int B, int Hq, int Hk, int S,
    int D, int bf16, const long long* strides, float scale, int causal, int window,
    void* stream) {
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
#define BWD_CASE(LAUNCH, DD)                                                                \
  if (D == DD)                                                                              \
    return LAUNCH(q, k, v, o, dout, l, sc, dq, dk, dv, B, Hq, Hk, S, st, scale, causal,     \
                  window, s);
  if (bf16) {
    BWD_CASE(tc::launch<32>, 32)
    BWD_CASE(tc::launch<64>, 64)
    BWD_CASE(tc::launch<128>, 128)
  } else {
    BWD_CASE(simt::launch<32>, 32)
    BWD_CASE(simt::launch<64>, 64)
    BWD_CASE(simt::launch<128>, 128)
  }
#undef BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
