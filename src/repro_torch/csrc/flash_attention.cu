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
// type, never by anything else.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one box of a 4-D (D, S, H, B) tensor map into shared memory; rows past S
// arrive as zeros and count toward the barrier's bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout; tiles sit on 1024-byte
// boundaries, so the base offset is 0
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo_bytes, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are still running
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads and writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// S[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// O[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O[64 x 32] += A[64 x 16] B[16 x 32], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x on the special-function unit alone (exp2f adds a denormal fix-up
// around it); flushes results below 2^-126 to 0, far below bf16's reach
// against the row's max, which maps to 1
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&x);
}

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
                              __nv_bfloat16* __restrict__ o, int Hq, int group, int S,
                              Strides os, float scale_log2, int causal, int window) {
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

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
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
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hk,
           int S, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
           int window, cudaStream_t stream) {
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
                                           static_cast<__nv_bfloat16*>(o), Hq, Hq / Hk, S,
                                           os, scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q [B, Hq, S, D], k and v [B, Hk, S, D], o [B, Hq, S, D], all float32
// (bf16 == 0) or all bfloat16 (bf16 == 1) on the current device, with unit
// stride along D, the given element strides of the batch, head and sequence
// axes in whole 16 bytes, 16-byte aligned; o contiguous for bf16.  D is 32,
// 64 or 128; window <= 0 means no window.  Launches on `stream`; returns the
// launch's cudaError_t (cudaErrorInvalidValue for a D or type it was not
// built for, or operands the tensor maps refuse).
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
#define FLASH_CASE(LAUNCH, DD)                                               \
  if (D == DD)                                                               \
    return LAUNCH(q, k, v, o, B, Hq, Hk, S, qs, ks, vs, os, scale, causal,   \
                  window, st);
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
