// Fixed-point max-min water-filling on a dense 0/1 incidence, one solve
// per launch.
//
// Replaces the Pallas TPU kernel `_maxmin_kernel` (with `_maxmin_padded`
// and `maxmin_kernel`) at src/repro/kernels/maxmin/kernel.py:30 and
// computes the same function as its oracle, src/repro/kernels/maxmin/ref.py.
// With inc [F, L] and cap [L], every round
//
//   users_l = sum_f inc[f,l] * active_f
//   share_l = users_l > 0 ? cap_l / users_l : BIG
//   s       = min_l share_l;   sat_l = share_l <= s && users_l > 0
//   newly_f = active_f && any_l(inc[f,l] && sat_l) && s < BIG
//   rate_f  = max(s, 0) where newly;   active_f &= !newly_f
//   cap_l   = cap_l - max(s, 0) * sum_f inc[f,l] * newly_f
//
// and flows still active at the end get NOLINK_RATE.  The TPU kernel runs a
// static L rounds; a round with s >= BIG changes nothing, and every later
// round recomputes the same s, so this kernel stops at the first such round
// (at most L rounds do work: each one empties every saturated link).
//
// What bounds it on Hopper: a round reads the incidence twice (the rows of
// the active flows, the columns of the newly frozen ones), about 2 F L
// float32 operations per round, so a solve is bound by bytes: one read of
// inc at 3.35 TB/s.  The analytic engine's solves freeze every flow within
// a few rounds, so the work is a few passes over inc, but every round needs
// three grid-wide barriers, which set the floor at small F x L.
//
// Design.  One persistent cooperative launch per solve
// (cudaLaunchCooperativeKernel, the grid sized from the occupancy query and
// the SM count so that every block is resident), with
// cooperative_groups::this_grid().sync() between the steps of a round.  It
// builds from one source without -rdc.  No padding.
//   row step:    one warp per flow, lanes striding over links, hit by
//                __any_sync; a newly frozen flow appends itself to a list.
//   column step: threads take (link, slice of the newly frozen list);
//                neighbouring threads read neighbouring links of one row.
//                Counts are integers, summed with integer atomics: exact
//                in any order, so the result is deterministic and equals
//                the oracle's float sums of 0/1 values.
//   link step:   one thread per link applies cap -= r * cnt with
//                __fmul_rn/__fsub_rn (no FMA contraction: two roundings,
//                as the plain version), users -= cnt, recomputes the share
//                with IEEE division, and reduces a per-block min.
//   Every block then reduces the per-block mins itself to the same s.
// Making it fast (wgmma, TMA, a sparse CSR form, batching many small
// solves into one launch) is later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2;       // fewer blocks, cheaper barriers
constexpr float kBig = 3e38f;            // the float32 value, as the oracle's
constexpr float kNoLinkRate = 1e12f;

struct Args {
  const float* inc;   // [F, L]
  const float* cap0;  // [L]
  float* rates;       // [F]
  float* cap;         // [L]  working capacities
  float* share;       // [L]
  float* partial;     // [gridDim.x] per-block min share
  int* users;         // [L]
  int* cnt;           // [L]
  int* active;        // [F]
  int* list;          // [F]  flows frozen this round
  int* counters;      // [0] length of list, [1] rounds that froze flows
  int F, L;
};

__device__ float block_min(float v, float* smem) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) smem[warp] = v;
  __syncthreads();
  v = threadIdx.x < kWarps ? smem[threadIdx.x] : INFINITY;
  if (warp == 0)
    for (int off = 16; off > 0; off >>= 1)
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (threadIdx.x == 0) smem[kWarps] = v;
  __syncthreads();
  v = smem[kWarps];
  __syncthreads();   // smem may be reused at once
  return v;
}

// out[l] += #{i < n : inc[f_i, l] != 0}, f_i = list ? list[i] : i.
__device__ void count_columns(const Args& a, const int* list, int n,
                              long long tid, long long nthreads) {
  const int L = a.L;
  if (L >= nthreads) {
    for (long long l = tid; l < L; l += nthreads) {
      int acc = 0;
      for (int i = 0; i < n; ++i) {
        const long long f = list ? list[i] : i;
        acc += a.inc[f * L + l] != 0.0f;
      }
      if (acc) atomicAdd(list ? &a.cnt[l] : &a.users[l], acc);
    }
    return;
  }
  const long long slices = nthreads / L;
  if (tid >= slices * L) return;
  const long long l = tid % L;
  int acc = 0;
  for (long long i = tid / L; i < n; i += slices) {
    const long long f = list ? list[i] : i;
    acc += a.inc[f * L + l] != 0.0f;
  }
  if (acc) atomicAdd(list ? &a.cnt[l] : &a.users[l], acc);
}

// cap -= r * cnt, users -= cnt, share from the new state; returns the
// block's min share (after every thread of the block has taken part).
__device__ float link_step(const Args& a, float r, long long tid,
                           long long nthreads, float* smem) {
  float local = INFINITY;
  for (long long l = tid; l < a.L; l += nthreads) {
    const int c = a.cnt[l];
    float cl = a.cap[l];
    int u = a.users[l];
    if (c) {
      cl = __fsub_rn(cl, __fmul_rn(r, static_cast<float>(c)));
      u -= c;
      a.cap[l] = cl;
      a.users[l] = u;
      a.cnt[l] = 0;
    }
    const float sh = u > 0 ? __fdiv_rn(cl, static_cast<float>(u)) : kBig;
    a.share[l] = sh;
    local = fminf(local, sh);
  }
  return block_min(local, smem);
}

__global__ void __launch_bounds__(kThreads)
maxmin_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float smem[kWarps + 1];
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long warp = tid >> 5;
  const long long nwarps = nthreads >> 5;
  const int F = a.F, L = a.L;

  for (long long l = tid; l < L; l += nthreads) {
    a.cap[l] = a.cap0[l];
    a.users[l] = 0;
    a.cnt[l] = 0;
  }
  for (long long f = tid; f < F; f += nthreads) {
    a.active[f] = 1;
    a.rates[f] = 0.0f;
  }
  if (tid == 0) a.counters[0] = 0;
  grid.sync();
  count_columns(a, nullptr, F, tid, nthreads);   // users over every flow
  grid.sync();
  float m = link_step(a, 0.0f, tid, nthreads, smem);
  if (threadIdx.x == 0) a.partial[blockIdx.x] = m;

  int rounds = 0;
  for (int round = 0; round < L; ++round) {
    grid.sync();
    // s: every block reduces the per-block mins to the same value
    float v = INFINITY;
    for (int b = threadIdx.x; b < gridDim.x; b += kThreads) v = fminf(v, a.partial[b]);
    const float s = block_min(v, smem);
    if (!(s < kBig)) break;                    // the rest would be identity
    ++rounds;
    const float r = fmaxf(s, 0.0f);

    // row step: freeze every active flow that crosses a saturated link
    for (long long f = warp; f < F; f += nwarps) {
      if (!a.active[f]) continue;              // uniform across the warp
      const float* row = a.inc + f * L;
      bool h = false;
      for (int l = lane; l < L; l += 32) h |= row[l] != 0.0f && a.share[l] <= s;
      if (__any_sync(0xffffffffu, h) && lane == 0) {
        a.rates[f] = r;
        a.active[f] = 0;
        a.list[atomicAdd(&a.counters[0], 1)] = static_cast<int>(f);
      }
    }
    grid.sync();
    count_columns(a, a.list, a.counters[0], tid, nthreads);
    grid.sync();
    if (tid == 0) a.counters[0] = 0;           // read by no one until the next row step
    m = link_step(a, r, tid, nthreads, smem);
    if (threadIdx.x == 0) a.partial[blockIdx.x] = m;
  }

  for (long long f = tid; f < F; f += nthreads)
    if (a.active[f]) a.rates[f] = kNoLinkRate;
  if (tid == 0) a.counters[1] = rounds;
}

}  // namespace

// inc [F, L] and cap [L] float32, contiguous, on the current device, with
// F >= 1, L >= 1 and F * L < 2^31.  Scratch: fscratch holds 2 L floats
// followed by `partial_len` per-block floats; iscratch 2 L + 2 F + 2 ints;
// iscratch's last int receives the number of rounds that froze flows.
// Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int maxmin_launch(const float* inc, const float* cap, float* rates,
                             float* fscratch, int* iscratch, int F, int L,
                             int partial_len, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0, coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, maxmin_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  per_sm = per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm;
  // no more blocks than the work fills: a warp per flow, a thread per link
  const long long want_threads =
      static_cast<long long>(F) * 32 > L ? static_cast<long long>(F) * 32 : L;
  long long blocks = (want_threads + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * per_sm) blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > partial_len) return static_cast<int>(cudaErrorInvalidValue);

  Args a;
  a.inc = inc;
  a.cap0 = cap;
  a.rates = rates;
  a.cap = fscratch;
  a.share = fscratch + L;
  a.partial = fscratch + 2 * static_cast<long long>(L);
  a.users = iscratch;
  a.cnt = iscratch + L;
  a.active = iscratch + 2 * static_cast<long long>(L);
  a.list = a.active + F;
  a.counters = a.list + F;
  a.F = F;
  a.L = L;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(maxmin_kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                                    params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
