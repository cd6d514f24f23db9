// One fused DCTCP fluid step for a batch of B independent partitions.
//
// Replaces the Pallas TPU kernel `_cca_step_kernel` (with `cca_step_padded`)
// at src/repro/kernels/cca_step/kernel.py:27 and computes the same function
// as its oracle, src/repro/kernels/cca_step/ref.py.  Per partition b, with
// the 0/1 incidence M[b] of shape [F, L]:
//
//   p_l   = clip((q - K) / 2K, 0, 1)                       per link
//   qd_f  = sum_l M[f,l] * q_l / bw_l,  rtt = rtt0 + qd    per flow
//   p_f   = max_l M[f,l] * p_l                              worst-hop mark
//   alpha, W: the DCTCP EWMA and window grow/cut, W clipped to [mss, 2 line rtt0]
//   R2    = min(W2 / rtt, line) while delivered < size, else 0
//   arr_l = sum_f M[f,l] * R2_f                             link arrivals
//
// What bounds it on Hopper: every step reads the incidence twice (once per
// kernel below) and does two flops per element, so it is bound by bytes -
// and at the fluid engine's partition sizes (F x L up to 1024 x 400, 1.6 MB,
// resident in the 50 MB L2) by launch latency, which the two launches of a
// step cannot hide.
//
// Design.  The TPU kernel carries the link arrivals across its sequential
// grid of flow blocks; Hopper's blocks run in no order, so the step is two
// kernels instead, each with a deterministic reduction order and no atomics:
//   cca_flow_kernel: one warp per (b, f).  Lanes stride over L (coalesced
//     reads of the row M[b,f,:]), reduce qd and p_f with shuffles, and lane
//     0 does the per-flow DCTCP update.
//   cca_link_kernel: one thread per (b, l), summing M[b,f,l] * R2[b,f] over
//     f in order; neighbouring threads read neighbouring columns of M.
// Making the step fast (one kernel per step, the whole scan resident on
// the card, CUDA graphs) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kFlowThreads = 256;   // 8 warps, 8 flows per block
constexpr int kLinkThreads = 128;

__global__ void cca_flow_kernel(
    int B, int F, int L,
    const float* __restrict__ W, const float* __restrict__ alpha,
    const float* __restrict__ delivered, const float* __restrict__ size,
    const float* __restrict__ line, const float* __restrict__ rtt0,
    const float* __restrict__ M, const float* __restrict__ q,
    const float* __restrict__ bw,
    float* __restrict__ R2, float* __restrict__ W2,
    float* __restrict__ alpha2, float* __restrict__ delivered2,
    float dt, float g, float ecn_k, float two_k, float mss) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(B) * F) return;   // uniform per warp
  const long long b = warp / F;
  const float* m_row = M + warp * L;
  const float* q_b = q + b * L;
  const float* bw_b = bw + b * L;

  float qd = 0.0f;
  float p_f = 0.0f;   // every M * p_l is >= 0 and L >= 1
  for (int l = lane; l < L; l += 32) {
    const float m = m_row[l];
    const float ql = q_b[l];
    const float p_l = fminf(fmaxf((ql - ecn_k) / two_k, 0.0f), 1.0f);
    qd += m * (ql / bw_b[l]);
    p_f = fmaxf(p_f, m * p_l);
  }
  for (int off = 16; off > 0; off >>= 1) {
    qd += __shfl_xor_sync(0xffffffffu, qd, off);
    p_f = fmaxf(p_f, __shfl_xor_sync(0xffffffffu, p_f, off));
  }
  if (lane != 0) return;

  const long long i = warp;
  const float r0 = rtt0[i];
  const float rtt = r0 + qd;
  const float dtn = dt / rtt;
  const float a = alpha[i];
  alpha2[i] = (1.0f - g * dtn) * a + g * dtn * p_f;
  const float w = W[i];
  const float grow = mss * dtn * (1.0f - p_f);
  const float cut = p_f * a * w / 2.0f * dtn;
  const float ln = line[i];
  const float w2 = fminf(fmaxf(w + grow - cut, mss), 2.0f * ln * r0);
  W2[i] = w2;
  const float d = delivered[i];
  const float sz = size[i];
  const float r2 = d < sz ? fminf(w2 / rtt, ln) : 0.0f;
  R2[i] = r2;
  delivered2[i] = fminf(d + r2 * dt, sz);
}

__global__ void cca_link_kernel(int B, int F, int L,
                                const float* __restrict__ M,
                                const float* __restrict__ R2,
                                float* __restrict__ arrivals) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * L) return;
  const long long b = idx / L;
  const long long l = idx - b * L;
  const float* m_col = M + b * F * L + l;
  const float* r_b = R2 + b * F;
  float acc = 0.0f;
  for (int f = 0; f < F; ++f) acc += m_col[static_cast<long long>(f) * L] * r_b[f];
  arrivals[idx] = acc;
}

}  // namespace

// All arrays are float32, contiguous, on the current device: flow vectors
// [B, F], link vectors [B, L], M [B, F, L].  Launches on `stream` and
// returns the cudaError_t of the launches (0 on success).
extern "C" int cca_step_launch(
    const float* W, const float* alpha, const float* delivered,
    const float* size, const float* line, const float* rtt0,
    const float* M, const float* q, const float* bw,
    float* R2, float* W2, float* alpha2, float* delivered2, float* arrivals,
    int B, int F, int L, float dt, float g, float ecn_k, float two_k,
    float mss, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long flow_threads = static_cast<long long>(B) * F * 32;
  const unsigned flow_blocks =
      static_cast<unsigned>((flow_threads + kFlowThreads - 1) / kFlowThreads);
  cca_flow_kernel<<<flow_blocks, kFlowThreads, 0, s>>>(
      B, F, L, W, alpha, delivered, size, line, rtt0, M, q, bw,
      R2, W2, alpha2, delivered2, dt, g, ecn_k, two_k, mss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long links = static_cast<long long>(B) * L;
  const unsigned link_blocks =
      static_cast<unsigned>((links + kLinkThreads - 1) / kLinkThreads);
  cca_link_kernel<<<link_blocks, kLinkThreads, 0, s>>>(B, F, L, M, R2, arrivals);
  return static_cast<int>(cudaGetLastError());
}
