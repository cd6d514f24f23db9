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
// Two kernels, one for each input type; `flash_attention_launch` picks by
// type, never by anything else.  When the caller asks for it (a gradient is
// wanted), both also write each row's log-sum-exp of the scaled logits,
// m + log(l) in float32 ([B, Hq, S]; +inf for a row with no key), which the
// backward (flash_attention_bwd.cu) recomputes P from; serving passes no
// buffer and writes nothing more.
//
// What bounds it on Hopper: at the serving path's prefill (granite-3-2b,
// [4, 32, 2048, 64] queries against [4, 8, 2048, 64] keys, causal, bf16) it
// does 68.7 GFLOP against 84 MB of inputs and output: operations, 0.069 ms at
// the bf16 tensor cores' 989 TFLOP/s against 0.025 ms for the bytes.
//
// bf16 (serving): `tc::flash_attention_tc_kernel`, warp-specialised on the
// tensor cores.  A block of 384 threads owns 128 query rows of one (b, h):
//   - warpgroup 2 is the producer: after `setmaxnreg` gives its registers
//     to the consumers, one thread loads the Q tile once and then the K and
//     V tiles of 128 keys by TMA into a ring of shared-memory stages (3, or
//     2 at D = 128), with `mbarrier`s marking each stage full (bytes
//     arrived) and empty (every consumer thread done).  The 4-D tensor maps
//     over (D, S, H, B) carry the operands' strides, so the layers'
//     [B, S, H, D] views transposed to [B, H, S, D] are read in place; boxes
//     are 64 columns (two at D = 128) of 128-byte swizzled rows (64-byte at
//     D = 32); rows past S arrive as zeros.  The maps are encoded on the
//     host per call, with `cuTensorMapEncodeTiled` found through the
//     runtime (no -lcuda);
//   - warpgroups 0 and 1 each own 64 rows.  S = Q K^T is `wgmma` m64n128k16
//     with both operands K-major in shared memory (K's rows are
//     D-contiguous: no transpose), float32 accumulate.  The online softmax
//     runs on the accumulator fragment in registers: a row lives in the 4
//     threads of a quad (two shuffles), 2^x on the special-function unit
//     (`ex2.approx`) with scale * log2(e) folded in, and the elementwise
//     mask only on tiles that cross the causal diagonal, the window's edge
//     or the ragged end.  O += P V is `wgmma` with P from registers (the
//     accumulator layout of 16 keys is the A fragment layout) and V
//     MN-major from shared memory through the transpose bit, so V is never
//     rewritten.  A tile's S = Q K^T is issued together with the previous
//     tile's O += P V, so that product runs under this tile's softmax;
//   - KV tiles outside the block's causal/window range are never loaded,
//     and a warpgroup skips the math of a tile outside its own rows' range;
//     blocks are issued longest rows first across all heads;
//   - the epilogue stages acc / max(l, 1e-30) as bf16 over the warpgroup's
//     own rows of the Q tile and writes it with 16-byte stores that never
//     touch rows >= S.
// At granite's prefill shape the softmax's 2^x (16 a clock per SM) takes
// about as long as the products at the tensor cores' peak, so the two have
// to overlap to come near the bound.
// Numerics: P is rounded to bf16 before P V, as the JAX model layer's
// `_sdpa` does (src/repro/models/layers.py:64) and the Pallas kernel does
// not (float32 p against v, kernel.py:59-63).  l sums the float32 p, before
// the rounding.  Held to the bf16 bar, 2e-2.
//
// float32 (the reference tests' bars, 2e-5, which TF32 on the tensor cores
// cannot meet): `simt::flash_attention_kernel`, one block of kBQ threads owns
// kBQ query rows of one (b, h), one row per thread, and loops over KV tiles
// itself:
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
// Every product is a float32 FMA outside the tensor cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

struct Strides {  // element strides of the batch, head and sequence axes
  long long b, h, s;
};

// ------------------------------------------------------------------------
// float32: one thread per query row, float32 FMAs
// ------------------------------------------------------------------------
namespace simt {

constexpr int kBQ = 128;  // query rows per block: one per thread
constexpr int kBK = 32;   // keys per shared-memory tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
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
                           float* __restrict__ lse,
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
  if (lse != nullptr)
    lse[static_cast<long long>(bh) * S + row] = l > 0.f ? m + logf(l) : CUDART_INF_F;
  const float denom = fmaxf(l, 1e-30f);
  T* o_row = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
  for (int d = 0; d < D; d += 4)
    store4(o_row + d, make_float4(acc[d] / denom, acc[d + 1] / denom,
                                  acc[d + 2] / denom, acc[d + 3] / denom));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hq / Hk, S, qs, ks, vs,
      os, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt


// ------------------------------------------------------------------------
// bf16: warp-specialised tensor-core kernel (wgmma, TMA ring, mbarriers)
// ------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;       // query rows per block: two consumer warpgroups of 64
constexpr int kBN = 128;       // keys per K/V tile
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; warpgroup 2 loads
static_assert(kBM == kBN, "one TMA box height, kBN rows, for Q, K and V");

template <int D>
struct Cfg {
  static constexpr int kBoxCols = D < 64 ? D : 64;       // a box row is at most 128 bytes
  static constexpr int kBoxes = D / kBoxCols;            // boxes across D (2 at D = 128)
  static constexpr int kRowBytes = kBoxCols * 2;         // = the swizzle span, 64 or 128
  static constexpr int kBoxBytes = kBN * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // one 128-row tile, all of D
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma descriptor: B128, B64
  static constexpr int kPvN = D < 64 ? D : 64;           // P.V instruction width
  static constexpr int kPvHalves = D / kPvN;             // P.V instructions per 16 keys
  static constexpr int kStages = D == 128 ? 2 : 3;       // K/V tiles in flight
  // shared memory from a 1024-aligned base: Q (which also stages the
  // output), kStages x (K, V), then the barriers
  static constexpr int kQ = 0;
  static constexpr int kKV = kTileBytes;
  static constexpr int kBar = kKV + kStages * 2 * kTileBytes;
  static constexpr int kSmem = 1024 + kBar + 8 * (1 + 3 * kStages);
};
static_assert(Cfg<32>::kSmem <= 232448 && Cfg<64>::kSmem <= 232448 && Cfg<128>::kSmem <= 232448,
              "a block's shared memory on Hopper");

using namespace hopper;

// One tile's online-softmax step on the S accumulator fragment of a
// thread (rows row0 and row0 + 8, columns col0, col0 + 1 of each 8 keys):
// masks (on edge tiles only) and scales into log2 units, updates the
// running max m and this thread's share of the running sum l, and turns s
// into the float32 p; returns the factor that rescales the rows' output.
__device__ __forceinline__ void softmax_step(float (&s)[kBN / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool edge, int j0, int row0,
                                             int col0, int S, int causal, int window,
                                             float scale_log2) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int row = row0 + 8 * ((i % 4) / 2);
      const int col = j0 + 8 * (i / 4) + col0 + (i % 2);
      const bool ok = col < S && (!causal || col <= row) && (window <= 0 || col > row - window);
      s[i] = ok ? s[i] * scale_log2 : -CUDART_INF_F;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] *= scale_log2;
  }
  float mx[2] = {m[0], m[1]};  // a row lives in the 4 threads of a quad
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_use[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r];  // a row with no key yet
    corr[r] = ex2(m[r] - m_use[r]);                // 0 before the first key
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    s[i] = ex2(s[i] - m_use[(i % 4) / 2]);
    l[(i % 4) / 2] += s[i];  // l sums the float32 p
  }
}

// P as the A operand of P V from registers: the accumulator layout of 16
// keys is the A fragment layout; rounded to bf16
__device__ __forceinline__ void pack_p(const float (&s)[kBN / 2], uint32_t (&p)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                              int Hq, int group, int S, Strides os, float scale_log2,
                              int causal, int window) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t q_full = base + C::kBar;
  auto k_full = [&](int st) { return base + C::kBar + 8 * (1 + st); };
  auto v_full = [&](int st) { return base + C::kBar + 8 * (1 + C::kStages + st); };
  auto kv_empty = [&](int st) { return base + C::kBar + 8 * (1 + 2 * C::kStages + st); };
  auto k_tile = [&](int st) { return base + C::kKV + st * 2 * C::kTileBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + C::kTileBytes; };

  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x - b * Hq;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest rows first
  // the keys any row of the block may see, in whole tiles
  const int k_end = causal ? min(q0 + kBM, S) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBN * kBN : 0;
  const int n_tiles = (k_end - k_begin + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(kv_empty(st), 2 * 128);  // every consumer thread releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the TMA ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, C::kTileBytes);
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load(base + C::kQ + x * C::kBoxBytes, &q_map, x * C::kBoxCols, q0, h, b, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % C::kStages;
        mbar_wait(kv_empty(st), ((t / C::kStages) & 1) ^ 1);
        const int j0 = k_begin + t * kBN;
        mbar_expect_tx(k_full(st), C::kTileBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(k_tile(st) + x * C::kBoxBytes, &k_map, x * C::kBoxCols, j0, hk, b,
                   k_full(st));
        mbar_expect_tx(v_full(st), C::kTileBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(v_tile(st) + x * C::kBoxBytes, &v_map, x * C::kBoxCols, j0, hk, b,
                   v_full(st));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x - wg * 128;
    const int lane = tid % 32;
    const int r_lo = q0 + 64 * wg;                      // the warpgroup's rows
    const int r_hi = min(r_lo + 63, S - 1);
    const int row0 = r_lo + 16 * (tid / 32) + lane / 4;  // this thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane % 4);                     // and columns col0, col0 + 1 of each 8
    // the warpgroup's own tiles t_first..t_last (none if all its rows are >= S)
    const int key_lo = window > 0 ? max(0, r_lo - window + 1) : 0;
    const int key_hi = causal ? r_hi + 1 : S;
    const int t_first = r_lo < S ? (key_lo - k_begin) / kBN : n_tiles;
    const int t_last = r_lo < S ? min(n_tiles - 1, (key_hi - 1 - k_begin) / kBN) : n_tiles - 1;
    auto edge = [&](int j0) {  // does the tile cross the diagonal, the window or S?
      return (causal && j0 + kBN - 1 > r_lo) || (window > 0 && j0 < r_hi - window + 1) ||
             j0 + kBN > S;
    };
    auto skip = [&](int t) {   // a tile outside the rows' range: keep the ring's order
      mbar_wait(k_full(t % C::kStages), (t / C::kStages) & 1);
      mbar_wait(v_full(t % C::kStages), (t / C::kStages) & 1);
      mbar_arrive(kv_empty(t % C::kStages));
    };
    float s[kBN / 2];                           // logits, then probabilities
    auto issue_qk = [&](int st) {  // S = Q K^T, K-major operands
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk * 16 / C::kBoxCols;
        const int off = (kk * 16 % C::kBoxCols) * 2;
        wgmma_ss_n128(s,
                      make_desc(base + C::kQ + x * C::kBoxBytes + 64 * wg * C::kRowBytes + off,
                                8 * C::kRowBytes, C::kLayout),
                      make_desc(k_tile(st) + x * C::kBoxBytes + off, 8 * C::kRowBytes,
                                C::kLayout),
                      kk > 0);
      }
      wgmma_commit();
    };

    uint32_t p[kBN / 16][4];                    // the previous tile's p in bf16
    float acc[C::kPvHalves][C::kPvN / 2];       // output, float32
#pragma unroll
    for (int x = 0; x < C::kPvHalves; ++x)
#pragma unroll
      for (int i = 0; i < C::kPvN / 2; ++i) acc[x][i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of the scaled logits
    float l[2] = {0.f, 0.f};                      // this thread's share of the running sum
    float corr[2];
    auto issue_pv = [&](int st) {  // O += P V, V MN-major through the transpose bit
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < C::kPvHalves; ++x)
          wgmma_rs(acc[x], p[kk],
                   make_desc(v_tile(st) + x * C::kBoxBytes + kk * 16 * C::kRowBytes,
                             8 * C::kRowBytes, C::kLayout));
      wgmma_commit();
    };
    auto fence_acc = [&] {
#pragma unroll
      for (int x = 0; x < C::kPvHalves; ++x) fence_regs(acc[x]);
    };

    mbar_wait(q_full, 0);
    for (int t = 0; t < t_first; ++t) skip(t);
    if (t_first <= t_last) {
      // the first tile: S, softmax, p
      int st = t_first % C::kStages;
      mbar_wait(k_full(st), (t_first / C::kStages) & 1);
      fence_regs(s);
      wgmma_fence();
      issue_qk(st);
      wgmma_wait<0>();
      fence_regs(s);
      int j0 = k_begin + t_first * kBN;
      softmax_step(s, m, l, corr, edge(j0), j0, row0, col0, S, causal, window, scale_log2);
      pack_p(s, p);
      // each later tile: its S = Q K^T runs beside the previous tile's
      // O += P V, and its softmax waits only for S
      for (int t = t_first + 1; t <= t_last; ++t) {
        const int prev = st;
        st = t % C::kStages;
        j0 = k_begin + t * kBN;
        mbar_wait(k_full(st), (t / C::kStages) & 1);
        mbar_wait(v_full(prev), ((t - 1) / C::kStages) & 1);
        fence_regs(s);
        fence_acc();
        wgmma_fence();
        issue_qk(st);
        issue_pv(prev);
        wgmma_wait<1>();  // S is in; P V may still run
        fence_regs(s);
        softmax_step(s, m, l, corr, edge(j0), j0, row0, col0, S, causal, window, scale_log2);
        wgmma_wait<0>();
        fence_acc();
        mbar_arrive(kv_empty(prev));
#pragma unroll
        for (int x = 0; x < C::kPvHalves; ++x)
#pragma unroll
          for (int i = 0; i < C::kPvN / 2; ++i) acc[x][i] *= corr[(i % 4) / 2];
        pack_p(s, p);
      }
      mbar_wait(v_full(st), (t_last / C::kStages) & 1);
      fence_acc();
      wgmma_fence();
      issue_pv(st);
      wgmma_wait<0>();
      fence_acc();
      mbar_arrive(kv_empty(st));
    }
    for (int t = t_last + 1; t < n_tiles; ++t) skip(t);

    // epilogue: acc / max(l, 1e-30) as bf16, staged over the warpgroup's own
    // rows of the Q tile (its last product is done; 16-byte chunks
    // XOR-swizzled by row), then 16-byte stores of the rows < S
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    constexpr int kChunks = C::kBoxCols / 8;       // 16-byte chunks in a box row
    constexpr int kSwz = kChunks < 8 ? kChunks : 8;
    auto o_at = [&](int lr, int col) {            // byte address of (row lr, column col)
      return smem + C::kQ + col / C::kBoxCols * C::kBoxBytes + (64 * wg + lr) * C::kRowBytes +
             ((col % C::kBoxCols / 8) ^ (lr % kSwz)) * 16 + col % 8 * 2;
    };
    if (lse != nullptr && lane % 4 == 0) {   // m is in log2 units of the scaled logits
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < S)
          lse[static_cast<long long>(blockIdx.x) * S + row0 + 8 * r] =
              l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : CUDART_INF_F;
    }
    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
    for (int x = 0; x < C::kPvHalves; ++x)
#pragma unroll
      for (int i = 0; i < C::kPvN / 2; i += 2) {
        const int rr = (i % 4) / 2;
        const int col = x * C::kPvN + 8 * (i / 4) + col0;
        *reinterpret_cast<uint32_t*>(o_at(row0 - r_lo + 8 * rr, col)) =
            pack_bf16(acc[x][i] * inv[rr], acc[x][i + 1] * inv[rr]);
      }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int it = 0; it < 64 * (D / 8) / 128; ++it) {
      const int idx = it * 128 + tid;
      const int lr = idx / (D / 8);
      const int col = idx % (D / 8) * 8;
      const int row = r_lo + lr;
      if (row < S)
        *reinterpret_cast<uint4*>(ob + row * os.s + col) =
            *reinterpret_cast<const uint4*>(o_at(lr, col));
    }
  }
}

// (D, S, H, B) bf16 map with the operand's element strides, boxes of
// kBoxCols x 128 rows, swizzled to the box row's width
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int S, int H, int B, Strides st) {
  using C = Cfg<D>;
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st.s) * 2, cuuint64_t(st.h) * 2,
                                 cuuint64_t(st.b) * 2};
  const cuuint32_t box[4] = {cuuint32_t(C::kBoxCols), cuuint32_t(kBN), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
           int Hk, int S, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int causal, int window, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!encode<D>(&q_map, q, S, Hq, B, qs) || !encode<D>(&k_map, k, S, Hk, B, ks) ||
      !encode<D>(&v_map, v, S, Hk, B, vs))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_tc_kernel<D>;
  constexpr int smem = Cfg<D>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (S + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(q_map, k_map, v_map,
                                           static_cast<__nv_bfloat16*>(o), lse, Hq, Hq / Hk,
                                           S, os, scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q [B, Hq, S, D], k and v [B, Hk, S, D], o [B, Hq, S, D], all float32
// (bf16 == 0) or all bfloat16 (bf16 == 1) on the current device, with unit
// stride along D, the given element strides of the batch, head and sequence
// axes in whole 16 bytes, 16-byte aligned; o contiguous for bf16.  D is 32,
// 64 or 128; window <= 0 means no window.  lse is null, or a contiguous
// float32 [B, Hq, S] that receives each row's log-sum-exp.  Launches on `stream`; returns the
// launch's cudaError_t (cudaErrorInvalidValue for a D or type it was not
// built for, or operands the tensor maps refuse).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int Hq,
    int Hk, int S, int D, int bf16, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int window,
    void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(LAUNCH, DD)                                               \
  if (D == DD)                                                               \
    return LAUNCH(q, k, v, o, static_cast<float*>(lse), B, Hq, Hk, S, qs, ks, \
                  vs, os, scale, causal, window, st);
  if (bf16) {
    FLASH_CASE(tc::launch<32>, 32)
    FLASH_CASE(tc::launch<64>, 64)
    FLASH_CASE(tc::launch<128>, 128)
  } else {
    FLASH_CASE((simt::launch<float, 32>), 32)
    FLASH_CASE((simt::launch<float, 64>), 64)
    FLASH_CASE((simt::launch<float, 128>), 128)
  }
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
