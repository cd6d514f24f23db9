// Fixed-point max-min water-filling on a dense 0/1 incidence, one solve
// per call.
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
// round recomputes the same s, so this stops at the first such round (at
// most L rounds do work: each one empties every saturated link).
//
// What bounds it on Hopper: the only large operand is inc, F x L float32,
// and a solve needs it once (67.6 MB at moe@1024's largest solve, 8064 x
// 2096: 20 us at 3.35 TB/s).  Its content is F x L bits, 32x less.  After
// that a round is a few integer operations per set bit and a division per
// link, so at small F x L (the 10k x 128 ceiling: 118 rounds) the floor is
// one barrier per round across the CTAs that hold the state.
//
// Design.  inc must be 0/1 (the wrapper refuses anything else, on both
// devices; a flag set here tells it).
//   pack     one streaming read of inc into row bitmasks: bit l % 32 of
//            word l / 32 of flow f's row, WLp = 4 ceil(L / 128) words a row.
//            A warp packs a 128-column chunk of a row: 16-byte loads when a
//            row is 16-byte aligned (L % 4 == 0), each lane's four values a
//            nibble, OR-reduced over 8 lanes into a word; else four 4-byte
//            loads a lane and a ballot per word.  Four chunks a warp are in
//            flight.  The same pass raises the flag for a value neither 0
//            nor 1.  The masks are small: 8064 x 2096 packs into 2.2 MB,
//            10 000 x 128 into 160 KB.
//   rounds   counts are exact integers: a frozen flow adds 1 to each of its
//            set row bits with integer reductions, so sums in any order equal
//            the oracle's float sums of 0/1 values.  Every CTA keeps a
//            replica of the link state (cap, users, share) and updates it
//            from the round's counts with __fmul_rn/__fsub_rn (no FMA
//            contraction: two roundings, as the plain version), divides in
//            IEEE and takes the same min, so every CTA knows s, and when to
//            stop, without another barrier.  A round: the saturated links'
//            mask (share <= s; a link with no users has share BIG > s), a
//            block barrier, hit_f = any(row_f & sat) with 16-byte loads for
//            every active flow and the frozen flows' counts, a barrier across
//            the CTAs, the links' update, and a block barrier for the min.
// Two regimes, chosen by the launch function from the shapes:
//   cluster  one thread-block cluster of C <= 16 CTAs (non-portable sizes
//            through cudaLaunchKernelEx) where the row masks fit in its
//            shared memory: each CTA holds a slice of the flows' rows and
//            the link replica.  A CTA counts its frozen flows' bits in its
//            own buffer (shared-memory reductions) and, after
//            cg::this_cluster().sync(), adds every CTA's count of each link
//            with loads through distributed shared memory, all issued before
//            the first is used.  Buffers alternate by round, and a CTA clears
//            the next round's as it reads this one: one cluster barrier a
//            round.  CTAs of 1024 threads: a cluster barrier costs more at
//            1024 threads than at 256 (tools/hopper_barriers.py), but the
//            flows' tests are bound by issue and latency, which more warps
//            hide.  Up to 2^14 entries a CTA the CTAs pack their own rows
//            from inc (one launch); above that one SM's read of its share
//            costs more than a launch, so a pack kernel over every SM writes
//            the masks to global memory and the CTAs load their slices from
//            L2 with bulk asynchronous copies (cp.async.bulk, completing on
//            an mbarrier): two launches.
//   grid     where the masks do not fit a cluster (or the cluster launch is
//            refused), one cooperative launch packs into global memory and
//            runs the rounds over L2-resident masks: a warp per flow, counts
//            by global atomics into three rotating buffers, one grid.sync()
//            a round.  Each block keeps the link replica in its shared
//            memory while 12 L bytes fit there (about 19 000 links), and
//            beyond that in global memory (maxmin_grid_kernel says how), so
//            any F x L < 2^31 is solved.
// At small F x L the rounds, not the bits, set the time: each is a chain of
// barriers and dependent shared-memory loads.
#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterThreads = 1024;
constexpr int kGridThreads = 512;
constexpr int kPackThreads = 256;
constexpr int kMaxCluster = 16;
constexpr int kFlowsPerCta = 1024;           // one flow a thread, where the masks allow
constexpr long long kFuseEntries = 1 << 14;  // entries a CTA packs itself, one SM's read
constexpr int kChunk = 4;                    // 128-column chunks a warp has in flight
constexpr float kBig = 3e38f;                // the float32 value, as the oracle's
constexpr float kNoLinkRate = 1e12f;

struct Solve {
  const float* inc;       // [F, L]
  const float* cap0;      // [L]
  float* rates;           // [F]
  const uint32_t* rows;   // [F, WLp] packed by maxmin_pack_kernel, or null: pack here
  const int* pack_bad;    // per-block flags of maxmin_pack_kernel (n_pack_bad of them)
  int n_pack_bad;
  uint32_t* rows_out;     // grid regime: where it packs [F, WLp]
  int* bad_out;           // grid regime: one flag per block
  int* cnt_g;             // grid regime: [3, L] counts
  float* cap_g;           // grid regime, link state in global memory: [2, L] cap
  int* users_g;           //   and [2, L] users, by round parity
  int* out;               // [0] rounds that froze flows, [1] 1 where inc is not 0/1
  int F, L, WLp, vec;     // vec: rows of inc are 16-byte aligned (L % 4 == 0)
};

__host__ __device__ inline int row_words(int L) { return 4 * ((L + 127) / 128); }

// Shared memory of one cluster CTA, in bytes from the dynamic base: row
// masks of its n_f flows, the saturated links' mask, cap, users, share, two
// count buffers of L, its flows' rates (negative while active), the copy
// barrier, the reduction slots and the 0/1 flag.
struct ClusterLayout {
  long long rows, sat, cap, users, share, cnt, rates, bar, red, bytes;
};

__host__ __device__ inline ClusterLayout cluster_layout(int L, int WLp, int n_f) {
  ClusterLayout c;
  c.rows = 0;
  c.sat = c.rows + 4ll * n_f * WLp;
  c.cap = c.sat + 4ll * WLp;
  c.users = c.cap + 4ll * L;
  c.share = c.users + 4ll * L;
  c.cnt = c.share + 4ll * L;
  c.rates = c.cnt + 8ll * L;
  c.bar = (c.rates + 4ll * n_f + 7) / 8 * 8;
  c.red = c.bar + 8;
  c.bytes = c.red + 4 * 33;
  return c;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The min of v over the block, in every thread, after one barrier; `red`
// holds a slot per warp.  The caller puts a barrier (the round's) between
// two calls, so that no warp refills a slot another has yet to read.
__device__ float block_min(float v, float* red) {
  const int lane = threadIdx.x & 31;
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : INFINITY;
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One to the int at shared address `addr`: a reduction without a return
// value, so nothing waits on it.
__device__ __forceinline__ void add_one(uint32_t addr) {
  asm volatile("red.shared.add.u32 [%0], 1;\n" :: "r"(addr) : "memory");
}

// The sum over the cluster's C CTAs of the int at shared address `addr` of
// each: every load issued before the first is used.
__device__ __forceinline__ int cluster_sum(uint32_t addr, int C) {
  int v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    v[r] = 0;
    if (r < C) {
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(r));
      asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v[r]) : "r"(remote) : "memory");
    }
  }
  int sum = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) sum += v[r];
  return sum;
}

__device__ __forceinline__ bool not_binary(float v) { return v != 0.0f && v != 1.0f; }

// Packs rows row0 .. row0 + n_rows - 1 of inc into dst (local row r at
// dst + r * WLp): work item i is 128-column chunk i % (WLp / 4) of local
// row i / (WLp / 4), and warp `warp` of `n_warps` takes items warp,
// warp + n_warps, ..., kChunk of them in flight.  Every word of every row
// is written, padding included.  Returns whether this lane saw a value
// that is neither 0 nor 1.
template <bool kVec>
__device__ bool pack_rows(const float* __restrict__ inc, int L, int WLp, long long row0,
                          long long n_rows, uint32_t* dst, long long warp, long long n_warps) {
  const int lane = threadIdx.x & 31;
  const int cpr = WLp >> 2;
  const long long n_items = n_rows * cpr;
  bool bad = false;
  for (long long base = warp; base < n_items; base += kChunk * n_warps) {
    float v[kChunk][4];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {          // every load first
      const long long it = base + u * n_warps;
      const long long r = it / cpr;
      const int c = static_cast<int>(it - r * cpr);
      const float* row = inc + (row0 + r) * L;
      if (kVec) {
        const int col = (c << 7) + (lane << 2);
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (it < n_items && col < L) x = *reinterpret_cast<const float4*>(row + col);
        v[u][0] = x.x; v[u][1] = x.y; v[u][2] = x.z; v[u][3] = x.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = (c << 7) + (j << 5) + lane;
          v[u][j] = (it < n_items && col < L) ? row[col] : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const long long it = base + u * n_warps;
      if (it >= n_items) break;                 // uniform across the warp
      const long long r = it / cpr;
      const int c = static_cast<int>(it - r * cpr);
      uint32_t* out = dst + r * WLp + (c << 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) bad |= not_binary(v[u][j]);
      if (kVec) {   // lane's 4 columns are bits 4 (lane % 8) .. + 3 of word lane / 8
        uint32_t x = static_cast<uint32_t>(v[u][0] != 0.0f) |
                     static_cast<uint32_t>(v[u][1] != 0.0f) << 1 |
                     static_cast<uint32_t>(v[u][2] != 0.0f) << 2 |
                     static_cast<uint32_t>(v[u][3] != 0.0f) << 3;
        x <<= (lane & 7) << 2;
        x |= __shfl_xor_sync(0xffffffffu, x, 1);
        x |= __shfl_xor_sync(0xffffffffu, x, 2);
        x |= __shfl_xor_sync(0xffffffffu, x, 4);
        if ((lane & 7) == 0) out[lane >> 3] = x;
      } else {      // word j: bit `lane` is column 32 j + lane of the chunk
        uint32_t mine = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t word = __ballot_sync(0xffffffffu, v[u][j] != 0.0f);
          if (lane == j) mine = word;
        }
        if (lane < 4) out[lane] = mine;
      }
    }
  }
  return bad;
}

__device__ __forceinline__ bool pack(const Solve& a, long long row0, long long n_rows,
                                     uint32_t* dst, long long warp, long long n_warps) {
  return a.vec ? pack_rows<true>(a.inc, a.L, a.WLp, row0, n_rows, dst, warp, n_warps)
               : pack_rows<false>(a.inc, a.L, a.WLp, row0, n_rows, dst, warp, n_warps);
}

// Calls visit(l) for every set bit l of a row of WLp words (WLp % 4 == 0,
// the row 16-byte aligned).
template <typename Visit>
__device__ __forceinline__ void for_each_bit(const uint32_t* row, int WLp, Visit visit) {
  const uint4* row4 = reinterpret_cast<const uint4*>(row);
  for (int q = 0; q < (WLp >> 2); ++q) {
    const uint4 x = row4[q];
    const uint32_t words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bits = words[j];
      while (bits) {
        visit((((q << 2) + j) << 5) + __ffs(bits) - 1);
        bits &= bits - 1;
      }
    }
  }
}

// share_l of the replicated link state
__device__ __forceinline__ float share_of(float cap, int users) {
  return users > 0 ? __fdiv_rn(cap, static_cast<float>(users)) : kBig;
}

// The saturated links' mask, a warp per word: share_l <= s (s < BIG, and a
// link with no users has share BIG)
__device__ __forceinline__ void saturated(const float* share, float s, int L, int WLp,
                                          uint32_t* sat) {
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < WLp; w += blockDim.x >> 5) {
    const int l = (w << 5) + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, l < L && share[l] <= s);
    if (lane == 0) sat[w] = word;
  }
}

// any(row & sat) over WLp words (WLp % 4 == 0, both 16-byte aligned)
__device__ __forceinline__ bool crosses(const uint32_t* row, const uint32_t* sat, int WLp) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  const uint4* s4 = reinterpret_cast<const uint4*>(sat);
  for (int q = 0; q < (WLp >> 2); ++q) {
    const uint4 x = r4[q], y = s4[q];
    if ((x.x & y.x) | (x.y & y.y) | (x.z & y.z) | (x.w & y.w)) return true;
  }
  return false;
}

// cap -= r * c, users -= c where c != 0 (two roundings, as the plain
// version); stores and returns the link's new share
__device__ __forceinline__ float apply_counts(float* cap, int* users, float* share, int l, int c,
                                              float r) {
  float cl = cap[l];
  int u = users[l];
  if (c) {
    cl = __fsub_rn(cl, __fmul_rn(r, static_cast<float>(c)));
    u -= c;
    cap[l] = cl;
    users[l] = u;
  }
  const float sh = share_of(cl, u);
  share[l] = sh;
  return sh;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

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

// bytes (a multiple of 16) from global to this CTA's shared memory, counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

__global__ void __launch_bounds__(kPackThreads) maxmin_pack_kernel(const Solve a, uint32_t* rows,
                                                                   int* bad) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int any = __syncthreads_or(pack(a, 0, a.F, rows, warp, n_warps));
  if (threadIdx.x == 0) bad[blockIdx.x] = any;
}

__global__ void __launch_bounds__(kClusterThreads, 1) maxmin_cluster_kernel(const Solve a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int F = a.F, L = a.L, WLp = a.WLp;
  const int n_f = (F + C - 1) / C;
  const int f0 = min(F, rank * n_f);
  const int nf = min(F, f0 + n_f) - f0;
  const ClusterLayout lay = cluster_layout(L, WLp, n_f);
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem + lay.rows);
  uint32_t* sat = reinterpret_cast<uint32_t*>(smem + lay.sat);
  float* cap = reinterpret_cast<float*>(smem + lay.cap);
  int* users = reinterpret_cast<int*>(smem + lay.users);
  float* share = reinterpret_cast<float*>(smem + lay.share);
  int* cnt = reinterpret_cast<int*>(smem + lay.cnt);            // buffer b at cnt + b * L
  float* rates = reinterpret_cast<float*>(smem + lay.rates);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  int* bad_flag = reinterpret_cast<int*>(red + 32);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // this CTA's count of link l in buffer b, at shared address cnt_at(b, l)
  const uint32_t cnt_addr = smem_u32(cnt);
  auto cnt_at = [&](int b, int l) { return cnt_addr + 4u * static_cast<uint32_t>(b * L + l); };

  for (int l = tid; l < 2 * L; l += nthreads) cnt[l] = 0;
  for (int i = tid; i < nf; i += nthreads) rates[i] = -1.0f;
  bool bad = false;
  if (a.rows) {   // the pack kernel's masks, this CTA's slice, from L2
    const uint32_t b = smem_u32(bar);
    if (tid == 0) {
      mbar_init(b, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const uint32_t bytes = static_cast<uint32_t>(4ll * nf * WLp);
    if (tid == 0 && bytes) {
      mbar_expect_tx(b, bytes);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(a.rows + 1ll * f0 * WLp);
      for (uint32_t off = 0; off < bytes; off += 32768)
        bulk_load(smem_u32(rows) + off, src + off, min(32768u, bytes - off), b);
    }
    for (int i = tid; i < a.n_pack_bad; i += nthreads) bad |= a.pack_bad[i] != 0;
    if (bytes) mbar_wait(b, 0);
  } else {
    bad = pack(a, f0, nf, rows, tid >> 5, nthreads >> 5);
  }
  const int any_bad = __syncthreads_or(bad);    // also: the masks are complete
  if (tid == 0) *bad_flag = any_bad;
  // users: this CTA's flows' set bits, into buffer 0
  for (int i = tid; i < nf; i += nthreads)
    for_each_bit(rows + 1ll * i * WLp, WLp, [&](int l) { add_one(cnt_at(0, l)); });
  cluster.sync();                                // S_0: every CTA's counts and flag are in
  const bool stop = cluster_sum(smem_u32(bad_flag), C) != 0;
  int rounds = 0;
  if (!stop) {
    float m = INFINITY;
    for (int l = tid; l < L; l += nthreads) {
      users[l] = cluster_sum(cnt_at(0, l), C);
      cap[l] = a.cap0[l];
      m = fminf(m, apply_counts(cap, users, share, l, 0, 0.0f));
    }
    float s = block_min(m, red);
    for (int round = 1; round <= L; ++round) {
      if (!(s < kBig)) break;                  // the rest would be identity
      ++rounds;
      const float rate = fmaxf(s, 0.0f);
      const int b = round & 1;
      saturated(share, s, L, WLp, sat);
      __syncthreads();
      for (int i = tid; i < nf; i += nthreads) {
        const uint32_t* row = rows + 1ll * i * WLp;
        if (rates[i] >= 0.0f || !crosses(row, sat, WLp)) continue;   // frozen, or not hit
        rates[i] = rate;
        for_each_bit(row, WLp, [&](int l) { add_one(cnt_at(b, l)); });
      }
      cluster.sync();                          // S_round: every CTA's counts are in
      // every CTA read the other buffer before S_round: clear ours for the next round
      int* next = cnt + (b ^ 1) * L;
      m = INFINITY;
      for (int l = tid; l < L; l += nthreads) {
        next[l] = 0;
        m = fminf(m, apply_counts(cap, users, share, l, cluster_sum(cnt_at(b, l), C), rate));
      }
      s = block_min(m, red);
    }
    for (int i = tid; i < nf; i += nthreads)
      a.rates[f0 + i] = rates[i] < 0.0f ? kNoLinkRate : rates[i];
  }
  if (rank == 0 && tid == 0) {
    a.out[0] = rounds;
    a.out[1] = stop;
  }
  cluster.sync();                                // no CTA leaves while others read its counts
}

// The grid regime, one cooperative launch.  kSharedLinks: every block keeps
// a replica of the link state in its shared memory (12 L bytes, as the
// cluster does).  Otherwise (L beyond what a block's shared memory holds)
// the link state lives in global memory, two buffers by round parity: the
// state after round j, S_j, in buffer j & 1, each block writing its slice
// of links after the round's barrier and computing every link's new value
// for the min.  A flow's test in round k needs S_{k-1}, which other blocks
// are still writing, so it recomputes the shares of the flow's set bits
// from S_{k-2} and round k-1's counts: the same operations on the same
// values, so the same bits.  One grid barrier a round either way.
template <bool kSharedLinks>
__global__ void __launch_bounds__(kGridThreads) maxmin_grid_kernel(const Solve a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int F = a.F, L = a.L, WLp = a.WLp;
  float* red = reinterpret_cast<float*>(smem);
  float* cap = red + 32;                          // kSharedLinks: the replica
  int* users = reinterpret_cast<int*>(cap + L);
  float* share = reinterpret_cast<float*>(users + L);
  uint32_t* sat = reinterpret_cast<uint32_t*>(share + L);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nthreads >> 5;
  const long long gtid = static_cast<long long>(blockIdx.x) * nthreads + tid;
  const long long gthreads = static_cast<long long>(gridDim.x) * nthreads;
  // this block's flows and links (a slice each)
  const long long n_fb = (F + gridDim.x - 1) / gridDim.x;
  const long long f0 = min(static_cast<long long>(F), blockIdx.x * n_fb);
  const long long f1 = min(static_cast<long long>(F), f0 + n_fb);
  const int n_lb = (L + gridDim.x - 1) / gridDim.x;
  const int l0 = min(L, static_cast<int>(blockIdx.x) * n_lb), l1 = min(L, l0 + n_lb);

  for (long long i = gtid; i < 3ll * L; i += gthreads) a.cnt_g[i] = 0;
  // a flow is active while its rate is negative; each flow's lane 0 owns it
  for (long long f = f0 + warp; f < f1; f += n_warps)
    if (lane == 0) a.rates[f] = -1.0f;
  const int any = __syncthreads_or(pack(a, 0, F, a.rows_out, gtid >> 5, gthreads >> 5));
  if (tid == 0) a.bad_out[blockIdx.x] = any;
  grid.sync();
  bool bad = false;
  for (int b = tid; b < static_cast<int>(gridDim.x); b += nthreads)
    bad |= __ldcg(&a.bad_out[b]) != 0;
  if (__syncthreads_or(bad)) {                   // every block sees the same flags
    if (blockIdx.x == 0 && tid == 0) {
      a.out[0] = 0;
      a.out[1] = 1;
    }
    return;
  }
  // the masks other blocks packed, read through L2 (__ldcg): no stale L1 line
  const uint32_t* rows = a.rows_out;
  // calls visit(l) for the set bits of this lane's words of flow f's row
  auto lane_bits = [&](long long f, auto visit) {
    for (int w = lane; w < WLp; w += 32) {
      uint32_t bits = __ldcg(&rows[f * WLp + w]);
      while (bits) {
        visit((w << 5) + __ffs(bits) - 1);
        bits &= bits - 1;
      }
    }
  };
  // users: every flow's set bits, into buffer 0
  for (long long f = f0 + warp; f < f1; f += n_warps)
    lane_bits(f, [&](int l) { atomicAdd(&a.cnt_g[l], 1); });
  grid.sync();                                   // S_0
  // kSharedLinks == false: S_j's cap and users in buffer j & 1 of cap_g, users_g
  auto cap_buf = [&](int j) { return a.cap_g + static_cast<long long>(j & 1) * L; };
  auto users_buf = [&](int j) { return a.users_g + static_cast<long long>(j & 1) * L; };
  float m = INFINITY;
  for (int l = tid; l < L; l += nthreads) {
    const float cl = a.cap0[l];
    const int u = __ldcg(&a.cnt_g[l]);
    if constexpr (kSharedLinks) {
      cap[l] = cl;
      users[l] = u;
      m = fminf(m, apply_counts(cap, users, share, l, 0, 0.0f));
    } else {
      if (l >= l0 && l < l1) {
        cap_buf(0)[l] = cl;
        users_buf(0)[l] = u;
      }
      m = fminf(m, share_of(cl, u));
    }
  }
  float s = block_min(m, red);
  float prev_rate = 0.0f;
  int rounds = 0;
  for (int round = 1; round <= L; ++round) {
    if (!(s < kBig)) break;
    ++rounds;
    const float rate = fmaxf(s, 0.0f);
    int* cnt = a.cnt_g + static_cast<long long>(round % 3) * L;
    // link l's share in S_{round-1}: from the replica, or recomputed
    auto share_before = [&](int l) {
      if (round == 1) return share_of(a.cap0[l], __ldcg(&a.cnt_g[l]));
      float cl = __ldcg(&cap_buf(round - 2)[l]);
      int u = __ldcg(&users_buf(round - 2)[l]);
      const int c = __ldcg(&a.cnt_g[static_cast<long long>((round - 1) % 3) * L + l]);
      if (c) {                                   // as apply_counts
        cl = __fsub_rn(cl, __fmul_rn(prev_rate, static_cast<float>(c)));
        u -= c;
      }
      return share_of(cl, u);
    };
    if constexpr (kSharedLinks) {
      saturated(share, s, L, WLp, sat);
      __syncthreads();
    }
    for (long long f = f0 + warp; f < f1; f += n_warps) {
      const bool live = __shfl_sync(0xffffffffu, lane == 0 && a.rates[f] < 0.0f, 0);
      if (!live) continue;
      bool h = false;
      if constexpr (kSharedLinks) {
        for (int w = lane; w < WLp; w += 32) h |= (__ldcg(&rows[f * WLp + w]) & sat[w]) != 0;
      } else {   // share <= s: the saturated links (s < BIG, a user-less link has BIG)
        lane_bits(f, [&](int l) { h |= share_before(l) <= s; });
      }
      if (!__any_sync(0xffffffffu, h)) continue;
      if (lane == 0) a.rates[f] = rate;
      lane_bits(f, [&](int l) { atomicAdd(&cnt[l], 1); });
    }
    grid.sync();                                 // S_round: this round's counts complete
    // the previous round's buffer was read before S_round: clear our slice of it
    int* prev = a.cnt_g + static_cast<long long>((round + 2) % 3) * L;
    for (int l = l0 + tid; l < l1; l += nthreads) prev[l] = 0;
    m = INFINITY;
    for (int l = tid; l < L; l += nthreads) {
      if constexpr (kSharedLinks) {
        m = fminf(m, apply_counts(cap, users, share, l, __ldcg(&cnt[l]), rate));
      } else {   // S_round from S_{round-1}, written before S_round
        float cl = __ldcg(&cap_buf(round - 1)[l]);
        int u = __ldcg(&users_buf(round - 1)[l]);
        const int c = __ldcg(&cnt[l]);
        if (c) {
          cl = __fsub_rn(cl, __fmul_rn(rate, static_cast<float>(c)));
          u -= c;
        }
        if (l >= l0 && l < l1) {
          cap_buf(round)[l] = cl;
          users_buf(round)[l] = u;
        }
        m = fminf(m, share_of(cl, u));
      }
    }
    s = block_min(m, red);
    prev_rate = rate;
  }
  for (long long f = f0 + warp; f < f1; f += n_warps)
    if (lane == 0 && a.rates[f] < 0.0f) a.rates[f] = kNoLinkRate;
  if (blockIdx.x == 0 && tid == 0) {
    a.out[0] = rounds;
    a.out[1] = 0;
  }
}

// How a solve of this shape runs on the current device.
struct Plan {
  int regime;          // 0 cluster, 1 grid
  int cluster;         // CTAs in the cluster (cluster regime)
  int kernels;         // launches per solve: 1, or 2 with the pack kernel
  int threads;         // per block of the rounds' kernel
  int blocks;          // of the rounds' kernel
  int pack_blocks;     // of the pack kernel, or 0
  long long smem;      // dynamic shared memory per block of the rounds' kernel
  long long scratch;   // int32 words of scratch the launch needs
  int global_links;    // grid regime: the link state in global memory
  int error;           // cudaError_t
};
constexpr int kPlanWords = 9;

// It sets the kernels' attributes on the current device and asks the
// occupancy calculator, which costs more than a launch: the caller keeps
// the plan and passes it to maxmin_launch.
Plan plan_for(int F, int L) {
  Plan p{};
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) {
    p.error = err;
    return p;
  }
  const int WLp = row_words(L);
  int C = 0;
  for (int c = 1; c <= kMaxCluster && !C; ++c)
    if (cluster_layout(L, WLp, (F + c - 1) / c).bytes <= optin) C = c;
  if (C) {
    C = std::max(C, std::min(kMaxCluster, (F + kFlowsPerCta - 1) / kFlowsPerCta));
    const long long bytes = cluster_layout(L, WLp, (F + C - 1) / C).bytes;
    // the function's limit, not this shape's size: plans are kept, and a
    // later plan must not lower the limit under an earlier one's launch
    err = cudaFuncSetAttribute(maxmin_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err == cudaSuccess && C > 8)
      err = cudaFuncSetAttribute(maxmin_cluster_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int n_clusters = 0;
    if (err == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = C;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(C);
      cfg.blockDim = dim3(kClusterThreads);
      cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&n_clusters, maxmin_cluster_kernel, &cfg);
    }
    if (err != cudaSuccess) {
      cudaGetLastError();      // a refused size is not a sticky error: try the grid
      n_clusters = 0;
    }
    if (n_clusters > 0) {
      p.regime = 0;
      p.cluster = C;
      p.threads = kClusterThreads;
      p.blocks = C;
      p.smem = bytes;
      if (static_cast<long long>(F) * L > kFuseEntries * C) {
        const long long items = static_cast<long long>(F) * (WLp / 4);
        const long long want = (items + (kPackThreads / 32) * kChunk - 1) / ((kPackThreads / 32) * kChunk);
        p.pack_blocks = static_cast<int>(
            std::min(want, static_cast<long long>(sms) * (2048 / kPackThreads)));
        p.kernels = 2;
        p.scratch = static_cast<long long>(F) * WLp + p.pack_blocks + 2;
      } else {
        p.kernels = 1;
        p.scratch = 2;
      }
      return p;
    }
  }
  // the link replica in shared memory where it fits, else in global memory
  const long long red_bytes = 4 * 32;
  const long long shared_bytes = red_bytes + 12ll * L + 4ll * WLp;
  p.global_links = shared_bytes > optin;
  const long long bytes = p.global_links ? red_bytes : shared_bytes;
  const void* kernel = p.global_links ? reinterpret_cast<const void*>(maxmin_grid_kernel<false>)
                                      : reinterpret_cast<const void*>(maxmin_grid_kernel<true>);
  int coop = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGridThreads,
                                                        static_cast<size_t>(bytes));
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) {
    p.error = err;
    return p;
  }
  p.regime = 1;
  p.kernels = 1;
  p.threads = kGridThreads;
  p.blocks = sms * std::min(per_sm, 2);
  p.smem = bytes;
  p.scratch = static_cast<long long>(F) * WLp + p.blocks + 3ll * L + (p.global_links ? 4ll * L : 0) + 2;
  return p;
}

}  // namespace

// The plan of a solve of F x L on the current device, as kPlanWords
// numbers: regime (0 cluster, 1 grid), cluster size, kernels a solve
// launches, threads and blocks of the rounds' kernel, pack kernel blocks,
// dynamic shared memory per block, int32 words of scratch, and 1 where the
// grid keeps the link state in global memory.  Returns 0 or a cudaError_t.
extern "C" int maxmin_plan(int F, int L, long long* out) {
  const Plan p = plan_for(F, L);
  const long long v[kPlanWords] = {p.regime, p.cluster, p.kernels, p.threads, p.blocks,
                                   p.pack_blocks, p.smem, p.scratch, p.global_links};
  for (int i = 0; i < kPlanWords; ++i) out[i] = v[i];
  return p.error;
}

// inc [F, L] and cap [L] float32, contiguous, on the current device, with
// F >= 1, L >= 1 and F * L < 2^31; rates [F]; `plan` what maxmin_plan gave
// for this shape on this device; scratch as many int32 words as the plan
// says, of which the last two receive the rounds that froze flows and 1
// where inc holds a value other than 0 or 1 (then rates are not written).
// Launches on `stream` and returns 0 or a cudaError_t.
extern "C" int maxmin_launch(const float* inc, const float* cap, float* rates, int* scratch,
                             long long scratch_words, int F, int L, const long long* plan,
                             void* stream) {
  Plan p{};
  p.regime = static_cast<int>(plan[0]);
  p.cluster = static_cast<int>(plan[1]);
  p.kernels = static_cast<int>(plan[2]);
  p.threads = static_cast<int>(plan[3]);
  p.blocks = static_cast<int>(plan[4]);
  p.pack_blocks = static_cast<int>(plan[5]);
  p.smem = plan[6];
  p.scratch = plan[7];
  p.global_links = static_cast<int>(plan[8]);
  if (scratch_words < p.scratch) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Solve a{};
  a.inc = inc;
  a.cap0 = cap;
  a.rates = rates;
  a.F = F;
  a.L = L;
  a.WLp = row_words(L);
  a.vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(inc) % 16 == 0;
  a.out = scratch + scratch_words - 2;
  uint32_t* rows = reinterpret_cast<uint32_t*>(scratch);
  const long long row_words_total = static_cast<long long>(F) * a.WLp;
  cudaError_t err = cudaSuccess;
  if (p.regime == 0) {
    if (p.kernels == 2) {
      a.rows = rows;
      a.pack_bad = scratch + row_words_total;
      a.n_pack_bad = p.pack_blocks;
      maxmin_pack_kernel<<<p.pack_blocks, kPackThreads, 0, s>>>(a, rows,
                                                                scratch + row_words_total);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(p.cluster);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, maxmin_cluster_kernel, a);
  } else {
    a.rows_out = rows;
    a.bad_out = scratch + row_words_total;
    a.cnt_g = a.bad_out + p.blocks;
    a.cap_g = reinterpret_cast<float*>(a.cnt_g + 3ll * L);
    a.users_g = a.cnt_g + 5ll * L;
    const void* kernel = p.global_links
                             ? reinterpret_cast<const void*>(maxmin_grid_kernel<false>)
                             : reinterpret_cast<const void*>(maxmin_grid_kernel<true>);
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel(kernel, dim3(p.blocks), dim3(p.threads), params,
                                      static_cast<size_t>(p.smem), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
