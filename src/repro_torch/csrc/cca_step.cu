// The DCTCP fluid scan: `steps` fused control steps of a batch of B
// independent partitions in one launch.
//
// Replaces the Pallas TPU kernel `_cca_step_kernel` (with `cca_step_padded`)
// at src/repro/kernels/cca_step/kernel.py:27, and with it the reference's
// `lax.scan` over that step (src/repro/net/fluid_jax.py:99-100).  One step
// computes the same function as the oracle src/repro/kernels/cca_step/ref.py
// followed by the queue update of fluid_jax.fluid_run.  Per partition b,
// with the 0/1 incidence M[b] of shape [F, L]:
//
//   p_l   = clip((q - K) / 2K, 0, 1)                       per link
//   qd_f  = sum_l M[f,l] * q_l / bw_l,  rtt = rtt0 + qd    per flow
//   p_f   = max_l M[f,l] * p_l                              worst-hop mark
//   alpha, W: the DCTCP EWMA and window grow/cut, W clipped to [mss, 2 line rtt0]
//   R2    = min(W2 / rtt, line) while delivered < size, else 0
//   arr_l = sum_f M[f,l] * R2_f                             link arrivals
//   q_l   = clip(q_l + (arr_l - bw_l) dt, 0, 64 K)
//
// What bounds it on Hopper: one step is a few flops per set bit of the
// incidence and about 25 per flow, and every step needs the whole previous
// step (all queues before any flow, all rates before any link).  At the
// fluid engine's partition sizes (F x L up to 1024 x 400) a step is a few
// microseconds of dependent work at most, so a launch per step would be
// set by launch latency and by re-reading the incidence; here the floor is
// the two block barriers of every step.
//
// Design.  One thread block per partition (gridDim.x = B) runs all steps
// with the partition's state resident:
//   prologue  the block reads M[b] once and packs it twice as bitmasks: by
//             rows (bit l%32 of rows[l/32][f] is M[f,l]) for the flows, by
//             columns (bit f%32 of cols[f/32][l]) for the links.  A warp
//             takes a 32 x 32 tile: 32 coalesced row reads, a ballot each,
//             and the column words from the ballots' bits.  A summary word
//             per row and per column marks its non-zero words (bit w % 32
//             of word w / 32), so a walk skips empty words: a real phase's
//             flow crosses 2-4 of moe@1024's 400 links, and a link carries
//             at most 16 of its 1024 flows.  The flow and link vectors are
//             copied beside the masks.
//   each step, two phases separated by __syncthreads():
//     flows   a thread owns a flow (striding when F > blockDim), walks the
//             set bits of its row with __ffs for qd and p_f, and does the
//             DCTCP update;
//     links   a thread owns a link, walks the set bits of its column for
//             the arrivals, and updates its queue, q / bw and p_l.
//   Rate and queue histories are coalesced stores of F and L floats a step,
//   time-major ([B, steps, F] and [B, steps, L]).
//   epilogue  with a window w, the steady detector of steady_scan.cu (the
//             Pallas `_steady_kernel`, src/repro/kernels/steady_scan/kernel.py:22)
//             over the last w steps of each flow's rate: during those steps
//             the flow's thread keeps a running max, min and float32 sum (in
//             increasing t, the order of steady_scan_kernel's loop, so the
//             result is bit-equal to it on the same history) in the
//             workspace, and the epilogue writes mean = sum / w and the
//             fluctuation with its atol dead band.  That saves the fluid
//             engine a second launch and the re-read of the history per phase.
// With M in {0, 1}, M * x is exactly x for finite x, so a term skipped for
// its 0 bit is the +0 the dense sum would add (bw > 0 keeps q / bw finite).
// Both sums accumulate in float64 and round once to float32: the sum rounded
// once, whatever the order, where the plain version's library product sums
// in blocks.  A sequential float32 sum drifts: over the ~1230 rates on each
// link of a 30 %-dense 4096 x 2048 incidence, 200 steps moved queues by 2.7
// bytes off the plain version (the bar is 1).
// A block has at most 512 threads, so ptxas may give each 128 registers.  At
// 1024 threads (64 registers) the float64 sums spilled, and 1024 threads'
// spills overflowed the L1 beside the workspace: 10.8 us a step at moe@1024.
// The workspace (masks and vectors) lives in shared memory when it fits
// the block's opt-in limit (1024 x 400: 154 KB of 227 KB), else in a global
// scratch buffer of B workspaces that the wrapper allocates, where L1/L2
// keep it: the same code through another pointer.  Every update rounds each
// operation on its own (__fmul_rn, __fadd_rn, ...: no FMA contraction), as
// the plain version's separate PyTorch kernels do, and divides in IEEE
// (the build has no --use_fast_math).  The order of every sum is fixed
// (increasing index), so two runs are bit-identical.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
// R, W, alpha, delivered, size, line, rtt0, and the window's max, min, sum
constexpr int kFlowVectors = 10;
constexpr int kLinkVectors = 4;   // q, bw, q / bw, p_l

struct ScanArgs {
  const float* M;          // [B, F, L] 0/1
  const float* line;       // [B, F]
  const float* rtt0;
  const float* size;
  const float* W;
  const float* alpha;
  const float* delivered;
  const float* bw;         // [B, L]
  const float* q;
  float* R_out;            // [B, F]
  float* W_out;
  float* alpha_out;
  float* delivered_out;
  float* q_out;            // [B, L]
  float* arrivals_out;     // [B, L], the last step's
  float* rate_hist;        // [B, steps, F] or null
  float* queue_hist;       // [B, steps, L] or null
  float* win_mean;         // [B, F], written when window > 0
  float* win_fluct;        // [B, F]
  uint32_t* scratch;       // B workspaces when they are not in shared memory
  int F, L, steps, window;
  float dt, g, ecn_k, two_k, q_max, mss, atol;
};

__host__ __device__ long long workspace_words(int F, int L) {
  const long long WL = (L + 31) / 32, WF = (F + 31) / 32;
  const long long SL = (WL + 31) / 32, SF = (WF + 31) / 32;
  return (WL + SL) * F + (WF + SF) * L + static_cast<long long>(kFlowVectors) * F +
         static_cast<long long>(kLinkVectors) * L;
}

// Calls visit(i) for every set bit i of a row or column of a bitmask, in
// increasing order: word w at words[w * stride], and bit w % 32 of
// sums[(w / 32) * stride] set where word w is not zero.
template <typename Visit>
__device__ __forceinline__ void for_each_bit(const uint32_t* sums, const uint32_t* words,
                                             int n_sums, long long stride, Visit visit) {
  for (int s = 0; s < n_sums; ++s) {
    uint32_t nonzero = sums[s * stride];
    while (nonzero) {
      const int w = (s << 5) + __ffs(nonzero) - 1;
      nonzero &= nonzero - 1;
      uint32_t bits = words[w * stride];
      while (bits) {
        visit((w << 5) + __ffs(bits) - 1);
        bits &= bits - 1;
      }
    }
  }
}

// The summary words of a bitmask of n_words words per row, rows 0 .. n - 1
// striding over the block's threads.
__device__ __forceinline__ void summarise(const uint32_t* words, uint32_t* sums, int n,
                                          int n_words) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    for (int s = 0; s < (n_words + 31) >> 5; ++s) {
      uint32_t nonzero = 0;
      for (int k = 0; k < 32 && (s << 5) + k < n_words; ++k)
        nonzero |= static_cast<uint32_t>(words[static_cast<long long>((s << 5) + k) * n + i] != 0u)
                   << k;
      sums[static_cast<long long>(s) * n + i] = nonzero;
    }
}

__device__ __forceinline__ float mark(float q, const ScanArgs& a) {
  return fminf(fmaxf(__fdiv_rn(__fsub_rn(q, a.ecn_k), a.two_k), 0.0f), 1.0f);
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads, 1) fluid_scan_kernel(const ScanArgs a) {
  extern __shared__ uint32_t smem[];
  const int F = a.F, L = a.L;
  const int WL = (L + 31) >> 5, WF = (F + 31) >> 5;
  const int SL = (WL + 31) >> 5, SF = (WF + 31) >> 5;
  const long long b = blockIdx.x;
  uint32_t* ws = kShared ? smem : a.scratch + b * workspace_words(F, L);
  uint32_t* rows = ws;                                    // [WL][F]
  uint32_t* cols = rows + static_cast<long long>(WL) * F; // [WF][L]
  uint32_t* row_sums = cols + static_cast<long long>(WF) * L;   // [SL][F]
  uint32_t* col_sums = row_sums + static_cast<long long>(SL) * F; // [SF][L]
  float* R = reinterpret_cast<float*>(col_sums + static_cast<long long>(SF) * L);
  float* W = R + F;
  float* alpha = W + F;
  float* dlv = alpha + F;
  float* size = dlv + F;
  float* line = size + F;
  float* rtt0 = line + F;
  float* win_max = rtt0 + F;
  float* win_min = win_max + F;
  float* win_sum = win_min + F;
  float* q = win_sum + F;
  float* bw = q + L;
  float* qbw = bw + L;
  float* pl = qbw + L;

  // prologue: the incidence as bitmasks, 32 x 32 tiles, one warp each
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const float* Mb = a.M + b * F * L;
  for (long long tile = warp; tile < static_cast<long long>(WF) * WL; tile += n_warps) {
    const int f0 = static_cast<int>(tile / WL) << 5;
    const int l = (static_cast<int>(tile % WL) << 5) + lane;
    uint32_t col = 0, row = 0;
#pragma unroll
    for (int h = 0; h < 32; h += 16) {         // 16 coalesced row reads in flight
      float m[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int f = f0 + h + i;
        m[i] = (f < F && l < L) ? Mb[static_cast<long long>(f) * L + l] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t word = __ballot_sync(0xffffffffu, m[i] != 0.0f);
        if (lane == h + i) row = word;         // flow f0 + h + i's bits over this tile's links
        col |= ((word >> lane) & 1u) << (h + i);   // link l's bits over this tile's flows
      }
    }
    if (f0 + lane < F) rows[static_cast<long long>(l >> 5) * F + f0 + lane] = row;
    if (l < L) cols[static_cast<long long>(f0 >> 5) * L + l] = col;
  }
  __syncthreads();
  summarise(rows, row_sums, F, WL);
  summarise(cols, col_sums, L, WF);
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const long long i = b * F + f;
    W[f] = a.W[i];
    alpha[f] = a.alpha[i];
    dlv[f] = a.delivered[i];
    size[f] = a.size[i];
    line[f] = a.line[i];
    rtt0[f] = a.rtt0[i];
    win_max[f] = -INFINITY;
    win_min[f] = INFINITY;
    win_sum[f] = 0.0f;
  }
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const float ql = a.q[b * L + l], bl = a.bw[b * L + l];
    q[l] = ql;
    bw[l] = bl;
    qbw[l] = __fdiv_rn(ql, bl);
    pl[l] = mark(ql, a);
  }
  __syncthreads();

  const int win_start = a.steps - a.window;   // steps when there is no window
  for (int t = 0; t < a.steps; ++t) {
    // flows: queue delay, worst-hop mark, the DCTCP update
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      double qd = 0.0;
      float p_f = 0.0f;
      for_each_bit(row_sums + f, rows + f, SL, F, [&](int l) {
        qd += qbw[l];
        p_f = fmaxf(p_f, pl[l]);
      });
      const float r0 = rtt0[f];
      const float rtt = __fadd_rn(r0, static_cast<float>(qd));
      const float dtn = __fdiv_rn(a.dt, rtt);
      const float gd = __fmul_rn(a.g, dtn);
      const float a0 = alpha[f];
      alpha[f] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, gd), a0), __fmul_rn(gd, p_f));
      const float w = W[f];
      const float grow = __fmul_rn(__fmul_rn(a.mss, dtn), __fsub_rn(1.0f, p_f));
      const float cut = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(p_f, a0), w), 0.5f), dtn);
      const float ln = line[f];
      const float w2 = fminf(fmaxf(__fsub_rn(__fadd_rn(w, grow), cut), a.mss),
                             __fmul_rn(__fmul_rn(2.0f, ln), r0));
      W[f] = w2;
      const float d = dlv[f], sz = size[f];
      const float r2 = d < sz ? fminf(__fdiv_rn(w2, rtt), ln) : 0.0f;
      R[f] = r2;
      dlv[f] = fminf(__fadd_rn(d, __fmul_rn(r2, a.dt)), sz);
      if (a.rate_hist) a.rate_hist[(b * a.steps + t) * F + f] = r2;
      if (t >= win_start) {
        win_max[f] = fmaxf(win_max[f], r2);
        win_min[f] = fminf(win_min[f], r2);
        win_sum[f] = __fadd_rn(win_sum[f], r2);
      }
    }
    __syncthreads();
    // links: arrivals, the queue update, the next step's q / bw and p_l
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      double sum = 0.0;
      for_each_bit(col_sums + l, cols + l, SF, L, [&](int f) { sum += R[f]; });
      const float arr = static_cast<float>(sum);
      const float bl = bw[l];
      const float q2 = fminf(fmaxf(__fadd_rn(q[l], __fmul_rn(__fsub_rn(arr, bl), a.dt)), 0.0f),
                             a.q_max);
      q[l] = q2;
      qbw[l] = __fdiv_rn(q2, bl);
      pl[l] = mark(q2, a);
      if (a.queue_hist) a.queue_hist[(b * a.steps + t) * L + l] = q2;
      if (t == a.steps - 1) a.arrivals_out[b * L + l] = arr;
    }
    __syncthreads();
  }

  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const long long i = b * F + f;
    a.R_out[i] = R[f];
    a.W_out[i] = W[f];
    a.alpha_out[i] = alpha[f];
    a.delivered_out[i] = dlv[f];
    if (a.window > 0) {   // steady_scan_kernel's epilogue, operation for operation
      const float mx = win_max[f], mn = win_min[f];
      const float m = __fdiv_rn(win_sum[f], static_cast<float>(a.window));
      const float fl = m > 0.0f ? __fdiv_rn(__fsub_rn(mx, mn), fmaxf(m, 1e-30f)) : INFINITY;
      a.win_fluct[i] = mx <= a.atol ? 0.0f : fl;
      a.win_mean[i] = m;
    }
  }
  for (int l = threadIdx.x; l < L; l += blockDim.x) a.q_out[b * L + l] = q[l];
}

// The largest dynamic shared memory a block may opt into on the current
// device, or a negative cudaError_t.
long long shared_optin() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? optin : -static_cast<long long>(err);
}

}  // namespace

// Bytes of one partition's workspace (bitmasks and vectors).
extern "C" long long fluid_scan_workspace_bytes(int F, int L) {
  return 4 * workspace_words(F, L);
}

// Bytes of global scratch a launch over B partitions needs on the current
// device: 0 when a workspace fits in shared memory, else B workspaces;
// negative on a CUDA error.
extern "C" long long fluid_scan_scratch_bytes(int B, int F, int L) {
  const long long optin = shared_optin();
  if (optin < 0) return optin;
  const long long bytes = fluid_scan_workspace_bytes(F, L);
  return bytes <= optin ? 0 : bytes * B;
}

// All arrays are float32, contiguous, on the current device: M [B, F, L],
// flow vectors [B, F], link vectors [B, L], histories [B, steps, F] and
// [B, steps, L] (null: not written), the window's mean and fluctuation
// [B, F] (written when 1 <= window <= steps; window 0: none), `scratch` as
// fluid_scan_scratch_bytes asks (null when that is 0).  steps >= 1,
// F, L >= 1.  Launches on `stream` and returns the cudaError_t of the
// launch (0 on success).
extern "C" int fluid_scan_launch(
    const float* M, const float* line, const float* rtt0, const float* size,
    const float* bw, const float* W, const float* alpha, const float* delivered,
    const float* q, float* R_out, float* W_out, float* alpha_out,
    float* delivered_out, float* q_out, float* arrivals_out, float* rate_hist,
    float* queue_hist, float* win_mean, float* win_fluct, void* scratch, int B, int F,
    int L, int steps, int window, float dt, float g, float ecn_k, float mss, float atol,
    void* stream) {
  if (window < 0 || window > steps) return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{M, line, rtt0, size, W, alpha, delivered, bw, q,
                   R_out, W_out, alpha_out, delivered_out, q_out, arrivals_out,
                   rate_hist, queue_hist, win_mean, win_fluct, static_cast<uint32_t*>(scratch),
                   F, L, steps, window, dt, g, ecn_k, 2.0f * ecn_k, 64.0f * ecn_k, mss, atol};
  const int widest = F > L ? F : L;
  const int threads = widest >= kMaxThreads ? kMaxThreads : ((widest + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    const long long optin = shared_optin();
    if (optin < 0) return static_cast<int>(-optin);
    const long long bytes = fluid_scan_workspace_bytes(F, L);
    if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        fluid_scan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    fluid_scan_kernel<true><<<B, threads, static_cast<size_t>(bytes), s>>>(a);
  } else {
    fluid_scan_kernel<false><<<B, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
