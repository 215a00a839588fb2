// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel here takes raw device pointers and a stream, launches on
// that stream, allocates nothing, and its C entry point returns the
// cudaError_t of the launch (0 = success). ray_tpu_torch/ops/dispatch.py
// builds these files into one shared library and raises on a non-zero
// return.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

// The reference kernels' mask value (ray_tpu/ops/attention.py _NEG_INF):
// finite, so exp(s - m) of a masked score underflows to 0 instead of
// producing NaN from (-inf) - (-inf).
constexpr float kNegInf = -2.0e30f;

// dtype codes shared with dispatch.DTYPE_CODES
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte loads: the unit a thread should move so a warp reads whole
// 512-byte runs. `unpack16` widens one to f32 (a bf16 is the high half of
// an f32, so the widening is exact and needs no conversion instruction).
template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / static_cast<int>(sizeof(T)); }

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& r, float* f) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& r, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Stages KEYS rows of K and V (rows [k0, k0 + KEYS), row r at element
// offset rows.kv_offset(r) of both bases) into shared memory as f32, in
// 16-byte loads: D and every row offset must be multiples of 16 bytes and
// the bases 16-byte aligned (`kv_layout_ok`; the entry points refuse other
// layouts). A tile is fetched into registers by `fetch` one tile ahead and
// written to shared memory by `store`, so the next tile's loads are in
// flight while the current one is computed. Keys at or past key_end read
// as 0.
template <typename T, int KEYS, int THREADS, int MAXD>
struct KVStager {
  static constexpr int kVE = vec_elems<T>();
  static constexpr int kNV = (KEYS * MAXD / kVE + THREADS - 1) / THREADS;
  uint4 kr[kNV], vr[kNV];

  template <typename Rows>
  __device__ void fetch(const Rows& rows, const T* k, const T* v, int k0, int key_end,
                        int D) {
    const int vpr = D / kVE, nvec = KEYS * vpr;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < nvec) {
        const int kk = idx / vpr, key = k0 + kk;
        if (key < key_end) {
          const size_t off = rows.kv_offset(key) + static_cast<size_t>(idx - kk * vpr) * kVE;
          kr[i] = load16(k + off);
          vr[i] = load16(v + off);
        }
      }
    }
  }

  __device__ void store(float* Ks, int ks_stride, float* Vs, int vs_stride, int D) const {
    const int vpr = D / kVE, nvec = KEYS * vpr;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < nvec) {
        const int kk = idx / vpr, c = (idx - kk * vpr) * kVE;
        float f[kVE];
        unpack16<T>(kr[i], f);
#pragma unroll
        for (int e = 0; e < kVE; ++e) Ks[kk * ks_stride + c + e] = f[e];
        unpack16<T>(vr[i], f);
#pragma unroll
        for (int e = 0; e < kVE; ++e) Vs[kk * vs_stride + c + e] = f[e];
      }
    }
  }
};

// Rows t of one (b, head) of a [B, T, heads, D] tensor read through its
// strides: the `kv_offset` that KVStager and tc::load_tile take.
struct Rows {
  long long sb, st, sh;
  int b, h;
  __device__ size_t kv_offset(int t) const {
    return static_cast<size_t>(b * sb + t * st + h * sh);
  }
};

// True when K/V rows of D elements at the given element strides from the
// bases k and v can be moved in KVStager's 16-byte loads.
template <typename T>
inline bool kv_layout_ok(const void* k, const void* v, int D, long long s0 = 0,
                         long long s1 = 0, long long s2 = 0) {
  constexpr int VE = vec_elems<T>();
  return D % VE == 0 && s0 % VE == 0 && s1 % VE == 0 && s2 % VE == 0 && aligned16(k) &&
         aligned16(v);
}

// SMs of the current device (a launch's choice of tile size reads it)
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Dynamic shared memory above the default 48 KB must be allowed per kernel
// before its first launch; below that no call is needed.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rtt

// Run a statement with `T` bound to the element type named by a dtype code;
// an unknown code returns cudaErrorInvalidValue from the enclosing function.
#define RTT_DISPATCH_DTYPE(code, T, ...)            \
  switch (code) {                                   \
    case rtt::kF32: {                               \
      using T = float;                              \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    case rtt::kBF16: {                              \
      using T = __nv_bfloat16;                      \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    default:                                        \
      return cudaErrorInvalidValue;                 \
  }
