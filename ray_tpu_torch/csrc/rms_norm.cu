// K1: RMSNorm, forward and backward, over the last axis of a [rows, D] block.
//
// Forward, `rtt_rms_norm`, replaces ray_tpu/ops/norm.py:31 `_rms_kernel`
// (launched by `_rms_pallas`):
//   y = (x * rsqrt(mean(x^2) + eps)) * w
// statistics in f32, y in x's dtype, w in its own dtype, rounded once, in the
// reference's order (x times inv, then times w).
//
// Backward, `rtt_rms_norm_bwd`, replaces the closed form the reference runs in
// XLA (ray_tpu/ops/norm.py:76 `_rms_bwd`; it has no Pallas kernel), which the
// port ran as ~15 eager PyTorch launches over f32 copies of the block:
//   inv = rsqrt(mean(x^2) + eps), xhat = x * inv, gw = g * w,
//   dx = inv * (gw - xhat * mean(gw * xhat))   in x's dtype,
//   dw = sum over rows of g * xhat              in w's dtype,
// f32 inside. Both row sums come from one pass over the row, since
// mean(gw * xhat) = inv * sum(gw * x) / D.
//
// What bounds them on the H100: bytes. The forward reads x and w once and
// writes y once, at ~4 flops per element; the backward reads x, g and w once
// and writes dx and dw once, at ~12 flops per element; both far below the
// card's ~20 f32 flops per byte. At the training shape ([8192, 2560], bf16 x,
// f32 w) the forward moves 83.9 MB (bound 0.0250 ms at 3.35 TB/s) and the
// backward 125.8 MB (0.0376 ms). At decode ([8, 4096] bf16, 64 KB) the bound
// is 0.00004 ms and the launch itself is the floor.
//
// What the design does about it:
// - One read of x from device memory. A row is cut into D / VEC groups of
//   VEC elements, a group being one load: 16 bytes (8 bf16 or 4 f32) when
//   every base is 16-byte aligned and a row is a multiple of 16 bytes (the
//   `_vec_` kernels), one element otherwise (the `_scalar_` kernels: any D,
//   any alignment). The tpr threads of a row each hold up to NV groups of x,
//   and of w, in registers; every load of the row is issued before the
//   reduction, and the output is computed from the registers, so a row costs
//   one round trip to memory and w is read once per row slot.
// - Threads per row chosen on the host from rows and D (`plan_fwd`): with few
//   rows (decode 8, verify 40, a 256-row prefill chunk: fewer than 4 per SM)
//   a block per row, one or two groups a thread (D = 4096 bf16: 512 threads
//   of one 16-byte group), so the row's loads all go out at once; with many
//   rows (training, 8192) the fewest warps per row that hold it in at most 8
//   groups a thread (D = 2560 bf16: 2 warps of 5 groups), 256-thread blocks,
//   so blocks stay small and resident and a row's sum crosses at most a few
//   warps. A row's sum adds warp shuffles, then the row's warps through
//   shared memory, always in the same order.
// - The backward runs one row slot per CTA (`plan_bwd`: at most 2 groups a
//   thread, D = 2560 bf16: 160 threads) and as many CTAs as fit on the card
//   at once; CTA b walks rows b, b + grid, ... and loads the next row's x and
//   g while the current row reduces and stores. Each thread owns the same
//   columns in every row, so w stays in registers as f32 and its share of
//   dw accumulates in f32 registers: no atomics. The CTA writes its f32
//   partial row of dw to a workspace the wrapper allocates, and a second
//   launch from the same entry point (`rms_norm_dw_kernel`) sums the partial
//   rows in a fixed order, so dw is bit-identical from call to call.
// - Rows wider than what the registers hold (more than 1024 threads x NV
//   groups; no model here) stream the rest of the row through a loop and
//   read it a second time after the reduction.

#include <algorithm>

#include "common.cuh"

namespace {

// N elements of T, aligned so that a 16-byte group is one 16-byte load
template <typename T, int N>
struct alignas(N * sizeof(T) >= 16 ? 16 : N * sizeof(T)) Arr {
  T v[N];
};

// One load (or store) of a group: 16-byte groups as uint4 (two for 32
// bytes), 8-byte ones as uint2, smaller ones as they are.
template <typename A>
__device__ __forceinline__ A load_arr(const void* p) {
  A a;
  if constexpr (sizeof(A) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(A) / 16); ++i)
      reinterpret_cast<uint4*>(&a)[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  } else if constexpr (sizeof(A) == 8) {
    *reinterpret_cast<uint2*>(&a) = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    a = *reinterpret_cast<const A*>(p);
  }
  return a;
}

template <typename A>
__device__ __forceinline__ void store_arr(void* p, const A& a) {
  if constexpr (sizeof(A) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(A) / 16); ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(&a)[i];
  } else if constexpr (sizeof(A) == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(&a);
  } else {
    *reinterpret_cast<A*>(p) = a;
  }
}

// Sum of v over the tpr threads of each row (tpr a multiple of 32, rows laid
// out in consecutive runs of tpr threads): shuffles within each warp, then
// the row's warps, in order, through red (one float per warp of the block).
// Every thread of the block must call it.
__device__ __forceinline__ float row_sum(float v, int tpr, float* red) {
  v = rtt::warp_sum(v);
  if (tpr == 32) return v;
  const int warp = threadIdx.x >> 5, wpr = tpr >> 5, first = warp - warp % wpr;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < wpr; ++i) s += red[first + i];
  return s;
}

// The same for two sums at once (red: two floats per warp).
__device__ __forceinline__ float2 row_sum2(float a, float b, int tpr, float* red) {
  a = rtt::warp_sum(a);
  b = rtt::warp_sum(b);
  if (tpr == 32) return make_float2(a, b);
  const int warp = threadIdx.x >> 5, wpr = tpr >> 5, first = warp - warp % wpr;
  if ((threadIdx.x & 31) == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  for (int i = 0; i < wpr; ++i) {
    s.x += red[2 * (first + i)];
    s.y += red[2 * (first + i) + 1];
  }
  return s;
}

// ------------------------------------------------------------------ forward

template <typename T, typename W, int VEC, int NV>
__device__ __forceinline__ void rms_fwd(const T* __restrict__ x, const W* __restrict__ w,
                                        T* __restrict__ y, int rows, int D, float eps,
                                        int tpr) {
  __shared__ float red[32];
  using XA = Arr<T, VEC>;
  using WA = Arr<W, VEC>;
  const int slot = threadIdx.x / tpr, t = threadIdx.x - slot * tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + slot;
  const int n = D / VEC;
  const bool live = row < rows;
  const T* xr = x + static_cast<size_t>(live ? row : 0) * D;
  T* yr = y + static_cast<size_t>(live ? row : 0) * D;

  // every load of the row's registered groups, x and w, before any use
  XA xv[NV];
  WA wv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int gi = t + i * tpr;
    if (live && gi < n) {
      xv[i] = load_arr<XA>(xr + gi * VEC);
      wv[i] = load_arr<WA>(w + gi * VEC);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (live && t + i * tpr < n) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = rtt::to_f32(xv[i].v[e]);
        ss = fmaf(v, v, ss);
      }
    }
  }
  const int wide = NV * tpr;  // groups past this stream through, read twice
  for (int gi = t + wide; live && gi < n; gi += tpr) {
    const XA a = load_arr<XA>(xr + gi * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float v = rtt::to_f32(a.v[e]);
      ss = fmaf(v, v, ss);
    }
  }
  ss = row_sum(ss, tpr, red);
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int gi = t + i * tpr;
    if (live && gi < n) {
      XA o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = rtt::from_f32<T>(rtt::to_f32(xv[i].v[e]) * inv * rtt::to_f32(wv[i].v[e]));
      store_arr(yr + gi * VEC, o);
    }
  }
  for (int gi = t + wide; live && gi < n; gi += tpr) {
    const XA a = load_arr<XA>(xr + gi * VEC);
    const WA b = load_arr<WA>(w + gi * VEC);
    XA o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = rtt::from_f32<T>(rtt::to_f32(a.v[e]) * inv * rtt::to_f32(b.v[e]));
    store_arr(yr + gi * VEC, o);
  }
}

// up to 2 groups a thread in blocks of up to 1024 threads (64 registers),
// more groups in blocks of up to 256 (plan_fwd keeps to this)
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(NV <= 2 ? 1024 : 256)
    rms_norm_fwd_vec_kernel(const T* __restrict__ x, const W* __restrict__ w,
                            T* __restrict__ y, int rows, int D, float eps, int tpr) {
  rms_fwd<T, W, rtt::vec_elems<T>(), NV>(x, w, y, rows, D, eps, tpr);
}

constexpr int kScalarFwdNV = 8;

template <typename T, typename W>
__global__ void __launch_bounds__(1024)
    rms_norm_fwd_scalar_kernel(const T* __restrict__ x, const W* __restrict__ w,
                               T* __restrict__ y, int rows, int D, float eps, int tpr) {
  rms_fwd<T, W, 1, kScalarFwdNV>(x, w, y, rows, D, eps, tpr);
}

// ----------------------------------------------------------------- backward

template <typename T, typename W, int VEC, int NV>
__device__ __forceinline__ void load_row(Arr<T, VEC> (&xv)[NV], Arr<T, VEC> (&gv)[NV],
                                         const T* __restrict__ x, const T* __restrict__ g,
                                         int row, int rows, int D, int n) {
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int gi = threadIdx.x + i * blockDim.x;
    if (gi < n) {
      xv[i] = load_arr<Arr<T, VEC>>(x + base + gi * VEC);
      gv[i] = load_arr<Arr<T, VEC>>(g + base + gi * VEC);
    }
  }
}

template <typename T, typename W, int VEC, int NV>
__device__ __forceinline__ void rms_bwd(const T* __restrict__ x, const W* __restrict__ w,
                                        const T* __restrict__ g, T* __restrict__ dx,
                                        float* __restrict__ part, int rows, int D,
                                        float eps) {
  __shared__ float red[2][64];  // two sums a warp, double-buffered by row parity
  using XA = Arr<T, VEC>;
  using WA = Arr<W, VEC>;
  const int t = threadIdx.x, tpr = blockDim.x, n = D / VEC, wide = NV * tpr;
  float* acc_row = part + static_cast<size_t>(blockIdx.x) * D;

  // this thread's columns of w (f32) and of the CTA's dw partial
  float wf[NV][VEC], acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int gi = t + i * tpr;
    WA a;
    if (gi < n) a = load_arr<WA>(w + gi * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      wf[i][e] = gi < n ? rtt::to_f32(a.v[e]) : 0.f;
      acc[i][e] = 0.f;
    }
  }
  for (int gi = t + wide; gi < n; gi += tpr) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc_row[gi * VEC + e] = 0.f;
  }

  XA xv[NV], gv[NV];
  load_row<T, W, VEC, NV>(xv, gv, x, g, blockIdx.x, rows, D, n);
  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const T* xr = x + static_cast<size_t>(row) * D;
    const T* gr = g + static_cast<size_t>(row) * D;
    float sxx = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (t + i * tpr < n) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xf = rtt::to_f32(xv[i].v[e]);
          sxx = fmaf(xf, xf, sxx);
          sgx = fmaf(rtt::to_f32(gv[i].v[e]) * wf[i][e], xf, sgx);
        }
      }
    }
    for (int gi = t + wide; gi < n; gi += tpr) {
      const XA a = load_arr<XA>(xr + gi * VEC), b = load_arr<XA>(gr + gi * VEC);
      const WA c = load_arr<WA>(w + gi * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xf = rtt::to_f32(a.v[e]);
        sxx = fmaf(xf, xf, sxx);
        sgx = fmaf(rtt::to_f32(b.v[e]) * rtt::to_f32(c.v[e]), xf, sgx);
      }
    }
    // the next row's loads go out before this row's reduction and stores
    XA xn[NV], gn[NV];
    load_row<T, W, VEC, NV>(xn, gn, x, g, row + gridDim.x, rows, D, n);
    const float2 s = row_sum2(sxx, sgx, tpr, red[parity]);
    const float inv = rsqrtf(s.x / static_cast<float>(D) + eps);
    const float m = inv * s.y / static_cast<float>(D);  // mean(gw * xhat)
    T* dr = dx + static_cast<size_t>(row) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int gi = t + i * tpr;
      if (gi < n) {
        XA o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = rtt::to_f32(xv[i].v[e]) * inv, gf = rtt::to_f32(gv[i].v[e]);
          o.v[e] = rtt::from_f32<T>(inv * (gf * wf[i][e] - xh * m));
          acc[i][e] = fmaf(gf, xh, acc[i][e]);
        }
        store_arr(dr + gi * VEC, o);
      }
    }
    for (int gi = t + wide; gi < n; gi += tpr) {
      const XA a = load_arr<XA>(xr + gi * VEC), b = load_arr<XA>(gr + gi * VEC);
      const WA c = load_arr<WA>(w + gi * VEC);
      XA o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = rtt::to_f32(a.v[e]) * inv, gf = rtt::to_f32(b.v[e]);
        o.v[e] = rtt::from_f32<T>(inv * (gf * rtt::to_f32(c.v[e]) - xh * m));
        acc_row[gi * VEC + e] = fmaf(gf, xh, acc_row[gi * VEC + e]);
      }
      store_arr(dr + gi * VEC, o);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xv[i] = xn[i];
      gv[i] = gn[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int gi = t + i * tpr;
    if (gi < n) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_row[gi * VEC + e] = acc[i][e];
    }
  }
}

constexpr int kBwdMaxThreads = 512;
constexpr int kScalarBwdNV = 4;

template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kBwdMaxThreads)
    rms_norm_bwd_vec_kernel(const T* __restrict__ x, const W* __restrict__ w,
                            const T* __restrict__ g, T* __restrict__ dx,
                            float* __restrict__ part, int rows, int D, float eps) {
  rms_bwd<T, W, rtt::vec_elems<T>(), NV>(x, w, g, dx, part, rows, D, eps);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kBwdMaxThreads)
    rms_norm_bwd_scalar_kernel(const T* __restrict__ x, const W* __restrict__ w,
                               const T* __restrict__ g, T* __restrict__ dx,
                               float* __restrict__ part, int rows, int D, float eps) {
  rms_bwd<T, W, 1, kScalarBwdNV>(x, w, g, dx, part, rows, D, eps);
}

// dw[c] = sum over the nparts partial rows of part[., c], in a fixed order:
// 16 row groups of a 32-column slab, then the 16 group sums in order
constexpr int kDwCols = 32, kDwGroups = 16;

template <typename W>
__global__ void __launch_bounds__(kDwCols * kDwGroups)
    rms_norm_dw_kernel(const float* __restrict__ part, W* __restrict__ dw, int nparts, int D) {
  __shared__ float s[kDwGroups][kDwCols + 1];
  const int c = blockIdx.x * kDwCols + threadIdx.x;
  float a = 0.f;
  if (c < D) {
#pragma unroll 8
    for (int b = threadIdx.y; b < nparts; b += kDwGroups) a += part[static_cast<size_t>(b) * D + c];
  }
  s[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kDwGroups; ++i) t += s[i][threadIdx.x];
    dw[c] = rtt::from_f32<W>(t);
  }
}

// ------------------------------------------------------------------- plans

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline int round32(int a) { return ceil_div(a, 32) * 32; }

struct Plan {
  int nv, tpr, rpb;  // groups a thread holds, threads a row, rows a block
};

// n groups a row. Few rows (fewer than 4 an SM): a block per row, one or
// two groups a thread. Many rows: the fewest warps a row that hold it in at
// most 8 groups a thread, 256-thread blocks. Groups past nv * tpr stream.
inline Plan plan_fwd(int rows, int n) {
  Plan p;
  if (rows < 4 * rtt::sm_count()) {
    p.nv = n <= 1024 ? 1 : 2;
    p.tpr = std::min(1024, round32(ceil_div(n, p.nv)));
    p.rpb = 1;
  } else {
    const int wpr = std::min(8, ceil_div(n, 32 * 8));
    p.tpr = 32 * wpr;
    p.nv = std::min(8, ceil_div(n, p.tpr));
    p.rpb = std::max(1, 256 / p.tpr);
  }
  return p;
}

// One row slot a CTA: the fewest warps that hold the row in at most 2 groups
// a thread, up to kBwdMaxThreads.
inline Plan plan_bwd(int n) {
  Plan p;
  const int wpr = std::min(kBwdMaxThreads / 32, ceil_div(n, 32 * 2));
  p.tpr = 32 * wpr;
  p.nv = std::min(2, ceil_div(n, p.tpr));
  p.rpb = 1;
  return p;
}

template <typename T, typename W>
cudaError_t launch_fwd(const void* x, const void* w, void* y, int rows, int D, float eps,
                       cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* yp = static_cast<T*>(y);
  constexpr int VE = rtt::vec_elems<T>();
  const bool vec = D % VE == 0 && rtt::aligned16(x) && rtt::aligned16(w) && rtt::aligned16(y);
  if (!vec) {
    Plan p;
    p.tpr = std::min(1024, round32(ceil_div(D, kScalarFwdNV)));
    p.rpb = std::max(1, 256 / p.tpr);
    rms_norm_fwd_scalar_kernel<T, W><<<ceil_div(rows, p.rpb), p.tpr * p.rpb, 0, s>>>(
        xp, wp, yp, rows, D, eps, p.tpr);
    return cudaGetLastError();
  }
  const Plan p = plan_fwd(rows, D / VE);
  const dim3 grid(ceil_div(rows, p.rpb)), block(p.tpr * p.rpb);
#define RTT_FWD(NV_)                                                                       \
  case NV_:                                                                                \
    rms_norm_fwd_vec_kernel<T, W, NV_><<<grid, block, 0, s>>>(xp, wp, yp, rows, D, eps,    \
                                                              p.tpr);                      \
    break;
  switch (p.nv) {
    RTT_FWD(1) RTT_FWD(2) RTT_FWD(3) RTT_FWD(4) RTT_FWD(5) RTT_FWD(6) RTT_FWD(7) RTT_FWD(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RTT_FWD
  return cudaGetLastError();
}

// The backward's grid: as many CTAs as are resident on the card at once, at
// most rows and at most the workspace's partial rows.
template <typename Kernel>
int bwd_grid(Kernel kernel, int tpr, int rows, int max_parts) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, tpr, 0) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  return std::min(std::min(rows, max_parts), per_sm * rtt::sm_count());
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* w, const void* g, void* dx, void* dw,
                       float* part, int max_parts, int rows, int D, float eps,
                       cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  constexpr int VE = rtt::vec_elems<T>();
  const bool vec = D % VE == 0 && rtt::aligned16(x) && rtt::aligned16(w) &&
                   rtt::aligned16(g) && rtt::aligned16(dx);
  int grid = 0;
  if (!vec) {
    const int tpr = std::min(kBwdMaxThreads, round32(ceil_div(D, kScalarBwdNV)));
    grid = bwd_grid(rms_norm_bwd_scalar_kernel<T, W>, tpr, rows, max_parts);
    rms_norm_bwd_scalar_kernel<T, W><<<grid, tpr, 0, s>>>(xp, wp, gp, dxp, part, rows, D, eps);
  } else {
    const Plan p = plan_bwd(D / VE);
    if (p.nv == 1) {
      grid = bwd_grid(rms_norm_bwd_vec_kernel<T, W, 1>, p.tpr, rows, max_parts);
      rms_norm_bwd_vec_kernel<T, W, 1><<<grid, p.tpr, 0, s>>>(xp, wp, gp, dxp, part, rows, D,
                                                              eps);
    } else {
      grid = bwd_grid(rms_norm_bwd_vec_kernel<T, W, 2>, p.tpr, rows, max_parts);
      rms_norm_bwd_vec_kernel<T, W, 2><<<grid, p.tpr, 0, s>>>(xp, wp, gp, dxp, part, rows, D,
                                                              eps);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_norm_dw_kernel<W><<<ceil_div(D, kDwCols), dim3(kDwCols, kDwGroups), 0, s>>>(
      part, static_cast<W*>(dw), grid, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_rms_norm(const void* x, const void* w, void* y, int rows, int D,
                            float eps, int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  RTT_DISPATCH_DTYPE(x_dtype, T, RTT_DISPATCH_DTYPE(w_dtype, W,
      err = launch_fwd<T, W>(x, w, y, rows, D, eps, s)));
  return err;
}

// ws: at least max_parts * D f32, the CTAs' partial rows of dw
extern "C" int rtt_rms_norm_bwd(const void* x, const void* w, const void* g, void* dx,
                                void* dw, void* ws, int max_parts, int rows, int D, float eps,
                                int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0 || D <= 0 || max_parts <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  cudaError_t err = cudaSuccess;
  RTT_DISPATCH_DTYPE(x_dtype, T, RTT_DISPATCH_DTYPE(w_dtype, W,
      err = launch_bwd<T, W>(x, w, g, dx, dw, part, max_parts, rows, D, eps, s)));
  return err;
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
