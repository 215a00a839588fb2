// The FMA tile loop: K2 (flash_attention.cu), K6 and K7 (paged chunk and
// paged verify attention in paged_attention.cu) for f32 inputs or a head
// dim other than 64 and 128. Replaces, in those cases, the tile loop of
// ray_tpu/ops/attention.py `_fwd_kernel` and of paged_attention.py
// `_chunk_kernel` / `_verify_kernel`. bf16 at head dim 64/128 runs all three
// on the tensor cores instead (flash_fwd_wgmma_kernel, paged_tile; wgmma.cuh).
//
// One CTA of 256 threads owns kTileR = 64 query rows that all read the same
// kv head. It stages them in shared memory once, then streams kTileK = 64
// keys at a time: K and V rows arrive by 16-byte loads one tile ahead
// (KVStager in common.cuh) and are widened to f32 in shared memory, the
// 64x64 score tile is computed with a 4x4 register tile per thread, a
// masked online softmax (f32 running max m, running sum l) rescales the
// 64 x D f32 accumulator held in registers, and P.V is added. Rows whose l
// stays 0 (every key masked) write 0, as the reference's `l == 0` guard does.
//
// A caller describes its problem with a struct that provides:
//   const T* q_row(int r)        query row r of the tile, nullptr past the end
//   size_t kv_offset(int key)    element offset of key's row in the K/V bases
//   bool visible(int r, int key) the per-row mask (keys >= key_end are masked
//                                here already)
//   T* out_row(int r)            output row r, nullptr past the end
//   const T* k, * v              K and V bases (same strides, kv_layout_ok)
// and the exclusive bound `key_end` of the keys any row of the tile may see.
// `lse`, when not null, receives row r's log-sum-exp m + log(l) (l == 0
// counts as 1, as in the reference) at lse[r] for every row with an output;
// callers that want none pass nullptr as a constant, so the epilogue code
// for it is not generated.
//
// What bounds it: each tile does 2*64*64*D multiply-adds per 64*D*2
// elements loaded, so the scalar FMA pipes bound it (K6 on this tile took
// 0.206 ms at C=256 against a 0.003 ms tensor-core bound; PERF.md). f32
// has no tensor-core path here.
#pragma once

#include "common.cuh"

namespace rtt {

constexpr int kTileR = 64;
constexpr int kTileK = 64;
constexpr int kTileThreads = 256;
constexpr int kTileMaxD = 128;

// Shared memory: Q [R][D+1], K [K][D+1], V [K][D], P [R][K+1], m/l/alpha [R].
// The +1 pads keep the column walks of the score loop free of bank conflicts.
inline size_t tile_smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kTileR) * (D + 1) + kTileK * (D + 1) +
                          kTileK * D + kTileR * (kTileK + 1) + 3 * kTileR);
}

template <typename T, typename Problem>
__device__ void attend_tile(const Problem& pb, int D, int key_end, float scale,
                            float* lse = nullptr) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTileR * (D + 1);
  float* Vs = Ks + kTileK * (D + 1);
  float* Ps = Vs + kTileK * D;
  float* m_s = Ps + kTileR * (kTileK + 1);
  float* l_s = m_s + kTileR;
  float* a_s = l_s + kTileR;

  const int tid = threadIdx.x;
  for (int idx = tid; idx < kTileR * D; idx += kTileThreads) {
    const int r = idx / D, d = idx - r * D;
    const T* q = pb.q_row(r);
    Qs[r * (D + 1) + d] = q ? to_f32(q[d]) : 0.f;
  }
  if (tid < kTileR) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // thread (ty, tx) owns rows ty*4 + i and, for scores, keys tx + 16*j;
  // for the output, columns tx + 16*j
  const int tx = tid & 15, ty = tid >> 4;
  constexpr int kCols = kTileMaxD / 16;
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  using Stager = KVStager<T, kTileK, kTileThreads, kTileMaxD>;
  Stager stager;
  if (key_end > 0) stager.fetch(pb, pb.k, pb.v, 0, key_end, D);
  for (int k0 = 0; k0 < key_end; k0 += kTileK) {
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    stager.store(Ks, D + 1, Vs, D, D);
    __syncthreads();
    if (k0 + kTileK < key_end) stager.fetch(pb, pb.k, pb.v, k0 + kTileK, key_end, D);

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    // unrolled on purpose: left to its heuristics the compiler unrolls this
    // loop about 3-fold in f32 and, depending on the rest of the kernel,
    // 16-fold or 3-fold in bf16; at the serving shapes the 16-fold loop is
    // about 7 % faster (PERF.md)
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, kk = tx + 16 * j, key = k0 + kk;
        const bool keep = key < key_end && pb.visible(r, key);
        Ps[r * (kTileK + 1) + kk] = keep ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row, 16 keys each
      const int r = tid >> 2, part = tid & 3;
      float* pr = Ps + r * (kTileK + 1) + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, mx);
      const bool live = m_next > 0.5f * kNegInf;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = live ? expf(pr[c] - m_next) : 0.f;
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_next);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_next;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= a;
    }
    for (int kk = 0; kk < kTileK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (kTileK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float v = Vs[kk * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], v, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // final l_s visible to every thread

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    T* out = pb.out_row(r);
    if (out == nullptr) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (d < D) out[d] = from_f32<T>(l == 0.f ? 0.f : acc[i][j] / l);
    }
    if (lse != nullptr && tx == 0) lse[r] = m_s[r] + logf(l == 0.f ? 1.f : l);
  }
}

}  // namespace rtt
