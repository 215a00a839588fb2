// K1: RMSNorm forward.
//
// Replaces ray_tpu/ops/norm.py `_rms_kernel` (launched by `_rms_pallas`):
//   y = x * rsqrt(mean(x^2) + eps) * w
// over the last axis, statistics in f32, y in x's dtype, w in its own dtype.
//
// Bound on the H100: bytes. Each element is read once and written once and
// takes four flops, far below the card's 295 flops per byte, so the kernel
// is as fast as it moves x and y. Design: one block per row (the model's
// rows are B tokens of width 4096 in decode, B*T in prefill), threads stride
// over the row so any D works; the sum of squares reduces in f32 through
// warp shuffles and one shared-memory step; the second pass re-reads the
// row, which one block just touched, from L1/L2 rather than from HBM.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                    int D, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * D;
  T* yr = y + static_cast<size_t>(blockIdx.x) * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = rtt::to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = rtt::warp_sum(ss);
  __shared__ float part[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? part[lane] : 0.f;
    v = rtt::warp_sum(v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(part[0] / static_cast<float>(D) + eps);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    yr[i] = rtt::from_f32<T>(rtt::to_f32(xr[i]) * inv * rtt::to_f32(w[i]));
  }
}

}  // namespace

extern "C" int rtt_rms_norm(const void* x, const void* w, void* y, int rows, int D,
                            float eps, int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RTT_DISPATCH_DTYPE(x_dtype, T, RTT_DISPATCH_DTYPE(w_dtype, W,
      rms_norm_kernel<T, W><<<rows, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), D, eps)));
  return cudaGetLastError();
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
