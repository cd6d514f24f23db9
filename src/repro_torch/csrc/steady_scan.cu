// Trailing-window max, min and mean of many rate series (paper Eq. 6/7).
//
// Replaces the Pallas TPU kernel `_steady_kernel` (with `steady_scan_padded`)
// at src/repro/kernels/steady_scan/kernel.py:22, and computes the same
// function as its oracle, src/repro/kernels/steady_scan/ref.py: for each
// series, over its last `window` samples,
//   mean  = sum / window
//   fluct = (max - min) / max(mean, 1e-30), inf where mean <= 0,
//           and 0 where max <= atol (the zero-pinned dead band).
//
// What bounds it on Hopper: one read of each windowed sample and three
// flops per sample, so bytes - and at the fluid engine's sizes ([200, F]
// histories, F <= 1024, 80 KB in the window) the launch itself.
//
// Design: one thread per series walks the window in order (so the mean is
// the same sequential float32 sum numpy takes along a time-major axis).
// The kernel takes batch, series and time strides, so the fluid engine's
// time-major [steps, F] history is read in place, without a transpose:
// neighbouring threads are neighbouring series, i.e. neighbouring addresses.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;

__global__ void steady_scan_kernel(const float* __restrict__ hist, int B,
                                   int F, int H, long long stride_b,
                                   long long stride_f, long long stride_h,
                                   int window, float atol,
                                   float* __restrict__ fluct,
                                   float* __restrict__ mean) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * F) return;
  const long long b = idx / F;
  const long long f = idx - b * F;
  const float* row = hist + b * stride_b + f * stride_f;
  float mx = -CUDART_INF_F;
  float mn = CUDART_INF_F;
  float sum = 0.0f;
  for (int t = H - window; t < H; ++t) {
    const float v = row[static_cast<long long>(t) * stride_h];
    mx = fmaxf(mx, v);
    mn = fminf(mn, v);
    sum += v;
  }
  const float m = sum / static_cast<float>(window);
  const float fl = m > 0.0f ? (mx - mn) / fmaxf(m, 1e-30f) : CUDART_INF_F;
  fluct[idx] = mx <= atol ? 0.0f : fl;
  mean[idx] = m;
}

}  // namespace

// hist: float32 on the current device, element (b, f, t) at
// hist[b*stride_b + f*stride_f + t*stride_h]; fluct and mean: contiguous
// [B, F].  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int steady_scan_launch(const float* hist, int B, int F, int H,
                                  long long stride_b, long long stride_f,
                                  long long stride_h, int window, float atol,
                                  float* fluct, float* mean, void* stream) {
  const long long rows = static_cast<long long>(B) * F;
  const unsigned blocks =
      static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  steady_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hist, B, F, H, stride_b, stride_f, stride_h, window, atol, fluct, mean);
  return static_cast<int>(cudaGetLastError());
}
