// K5, K6 and K7: attention over the serving engine's paged KV cache.
//
// Pool layout per layer: [KVH, P, ps, D] (the engine's [L, KVH, P, ps, D]
// pool sliced at one layer, passed as a pointer, never copied). A sequence's
// key j lives in page table[j / ps], slot j % ps. Every CTA reads its own
// page ids from the table: the GPU has no scalar prefetch.
//
// K5 `rtt_paged_attention_decode` replaces ray_tpu/ops/paged_attention.py
// `_paged_kernel` (launched by `_paged_pallas`, loop `_flash_page_loop`):
// one query token per sequence over its first lengths[b] keys; lengths[b]
// of 0 (an inactive engine slot) gives zeros. Bound: bytes. A decode step
// reads each live key and value once and does 2*g flops per element read,
// so the kernel is as fast as it streams the pages. Design: one CTA per
// (sequence, kv head) holds the g = H / KVH query rows of that kv head, so a
// K/V row is loaded once for the whole group; keys stream 64 at a time
// through shared memory (16-byte loads issued one tile ahead, widened to
// f32; common.cuh KVStager) under an f32 online softmax. Where the TPU
// kernel double-buffers page DMAs, the next tile's loads are in flight in
// registers while this one is computed. The grid is B * KVH CTAs (64 at the engine's B = 8,
// KVH = 8), half of the card's 132 SMs: splitting each sequence's keys
// over several CTAs (flash-decoding) is later work.
//
// K6 `rtt_paged_attention_chunk` replaces `_chunk_kernel` (launched by
// `_chunk_pallas`): one sequence's chunk of C queries; key j is visible to
// chunk row c iff j <= start + c and j < total, and only the first
// ceil(total / ps) pages are read. The TPU grid was (KVH,): eight programs,
// which would leave most of 132 SMs idle, so here the C*g query rows of a kv
// head (row = c*g + head within the group) are cut into 64-row tiles, grid
// (ceil(C*g / 64), KVH), each run by the tile loop of attention_tile.cuh.
//
// K7 `rtt_paged_attention_verify` replaces `_verify_kernel` (launched by
// `_verify_pallas`): the speculative-verify span, S = k + 1 query rows per
// sequence for the whole batch in one launch; key j is visible to row s of
// sequence b iff j <= positions[b] + s, and no key past the sequence's own
// table row (pps pages) is read. Each CTA reads positions[b] itself, so a
// verify round needs no readback before the launch. Bound: bytes, as for
// decode: a sequence's live K/V rows are read once per kv head and serve
// all S*g rows of that head. The TPU wrapper transposes q to
// [B, KVH, S*g, D] and the output back so that a block holds one kv head's
// rows; here row (s, kvh*g + gi) of [B, S, H, D] is indexed in place and
// both copies are gone. Per sequence this is K6's problem with start =
// positions[b], so the kernel fills a ChunkProblem per (row tile, kv head,
// sequence), grid (ceil(S*g / 64), KVH, B), and runs the same tile loop.
// At the engine's S = 5, g = 4 a tile holds 20 live rows of 64: the tile's
// idle rows cost FMA time, not bytes; a narrower tile is later work.

#include "attention_tile.cuh"

namespace {

constexpr int kDecKeys = 64;  // keys per step of the decode loop
constexpr int kDecThreads = 256;

size_t decode_smem_bytes(int g, int D) {
  // q [g][D], K [64][D+1], V [64][D], P [g][64], acc [g][D], m/l/alpha [g]
  return sizeof(float) * (static_cast<size_t>(g) * D + kDecKeys * (D + 1) + kDecKeys * D +
                          g * kDecKeys + static_cast<size_t>(g) * D + 3 * g);
}

// Rows of one (sequence, kv head): key j of the sequence in its page.
struct DecodeRows {
  const int* trow;
  int kvh, P, ps, D;
  __device__ size_t kv_offset(int key) const {
    return ((static_cast<size_t>(kvh) * P + trow[key / ps]) * ps + key % ps) * D;
  }
};

// One CTA per SM is all the grid can use (B * KVH CTAs, 64 at the engine's
// shapes), so the compiler is told not to trade registers for a second one.
template <typename T>
__global__ void __launch_bounds__(kDecThreads, 1)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages, const int* __restrict__ table,
                        const int* __restrict__ lengths, T* __restrict__ o, int H, int KVH,
                        int D, int P, int ps, int pps, float scale) {
  const int kvh = blockIdx.x, b = blockIdx.y, g = H / KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a length past the table (a finished slot riding out its span) reads no
  // page beyond this sequence's row
  const int len = min(lengths[b], pps * ps);
  const size_t row0 = (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * g) * D;
  T* ob = o + row0;
  if (len <= 0) {
    for (int idx = tid; idx < g * D; idx += kDecThreads) ob[idx] = rtt::from_f32<T>(0.f);
    return;
  }

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + g * D;
  float* vs = ks + kDecKeys * (D + 1);
  float* sc = vs + kDecKeys * D;
  float* acc = sc + g * kDecKeys;
  float* m_s = acc + g * D;
  float* l_s = m_s + g;
  float* a_s = l_s + g;

  for (int idx = tid; idx < g * D; idx += kDecThreads) {
    qs[idx] = rtt::to_f32(q[row0 + idx]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < g; r += kDecThreads) {
    m_s[r] = rtt::kNegInf;
    l_s[r] = 0.f;
  }
  const DecodeRows rows{table + static_cast<size_t>(b) * pps, kvh, P, ps, D};
  rtt::KVStager<T, kDecKeys, kDecThreads, rtt::kTileMaxD> stager;
  stager.fetch(rows, k_pages, v_pages, 0, len, D);

  for (int k0 = 0; k0 < len; k0 += kDecKeys) {
    __syncthreads();
    stager.store(ks, D + 1, vs, D, D);
    __syncthreads();
    if (k0 + kDecKeys < len) stager.fetch(rows, k_pages, v_pages, k0 + kDecKeys, len, D);
    for (int idx = tid; idx < g * kDecKeys; idx += kDecThreads) {
      const int r = idx / kDecKeys, kk = idx - r * kDecKeys;
      const float* qr = qs + r * D;
      const float* kr = ks + kk * (D + 1);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;  // four chains, not one
      int d = 0;
      for (; d + 3 < D; d += 4) {
        s0 = fmaf(qr[d], kr[d], s0);
        s1 = fmaf(qr[d + 1], kr[d + 1], s1);
        s2 = fmaf(qr[d + 2], kr[d + 2], s2);
        s3 = fmaf(qr[d + 3], kr[d + 3], s3);
      }
      for (; d < D; ++d) s0 = fmaf(qr[d], kr[d], s0);
      sc[idx] = k0 + kk < len ? ((s0 + s1) + (s2 + s3)) * scale : rtt::kNegInf;
    }
    __syncthreads();
    for (int r = warp; r < g; r += kDecThreads / 32) {  // a warp per query row
      float* pr = sc + r * kDecKeys;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, rtt::warp_max(fmaxf(x0, x1)));
      const bool live = m_next > 0.5f * rtt::kNegInf;
      const float p0 = live ? expf(x0 - m_next) : 0.f;
      const float p1 = live ? expf(x1 - m_next) : 0.f;
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = rtt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_next;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < g * D; idx += kDecThreads) {
      const int r = idx / D, d = idx - r * D;
      const float* pr = sc + r * kDecKeys;
      float a = acc[idx] * a_s[r];
#pragma unroll 8
      for (int kk = 0; kk < kDecKeys; ++kk) a = fmaf(pr[kk], vs[kk * D + d], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * D; idx += kDecThreads) {
    const float l = l_s[idx / D];
    ob[idx] = rtt::from_f32<T>(l == 0.f ? 0.f : acc[idx] / l);
  }
}

template <typename T>
struct ChunkProblem {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  const int* table;
  int kvh, r0, rows, g, H, D, P, ps, start;

  __device__ size_t row_offset(int r) const {
    const int R = r0 + r, c = R / g;
    return (static_cast<size_t>(c) * H + static_cast<size_t>(kvh) * g + (R - c * g)) * D;
  }
  __device__ const T* q_row(int r) const { return r0 + r < rows ? q + row_offset(r) : nullptr; }
  __device__ size_t kv_offset(int key) const {
    return ((static_cast<size_t>(kvh) * P + table[key / ps]) * ps + key % ps) * D;
  }
  __device__ bool visible(int r, int key) const { return key <= start + (r0 + r) / g; }
  __device__ T* out_row(int r) const { return r0 + r < rows ? o + row_offset(r) : nullptr; }
};

template <typename T>
__global__ void __launch_bounds__(rtt::kTileThreads)
    paged_chunk_kernel(const T* q, const T* k_pages, const T* v_pages, const int* table, T* o,
                       int C, int H, int KVH, int D, int P, int ps, int pps, int start,
                       int total, float scale) {
  ChunkProblem<T> pb;
  pb.q = q;
  pb.k = k_pages;
  pb.v = v_pages;
  pb.o = o;
  pb.table = table;
  pb.kvh = blockIdx.y;
  pb.g = H / KVH;
  pb.r0 = blockIdx.x * rtt::kTileR;
  pb.rows = C * pb.g;
  pb.H = H;
  pb.D = D;
  pb.P = P;
  pb.ps = ps;
  pb.start = start;
  // the tile's last row sees keys up to start + its chunk index; no row
  // sees total or beyond, and no key lies past the table
  const int last_row = min(pb.r0 + rtt::kTileR, pb.rows) - 1;
  const int key_end = min(min(total, start + last_row / pb.g + 1), pps * ps);
  rtt::attend_tile<T>(pb, D, key_end, scale);
}

template <typename T>
__global__ void __launch_bounds__(rtt::kTileThreads)
    paged_verify_kernel(const T* q, const T* k_pages, const T* v_pages, const int* table,
                        const int* positions, T* o, int S, int H, int KVH, int D, int P,
                        int ps, int pps, float scale) {
  const int b = blockIdx.z;
  const size_t seq = static_cast<size_t>(b) * S * H * D;
  ChunkProblem<T> pb;
  pb.q = q + seq;
  pb.k = k_pages;
  pb.v = v_pages;
  pb.o = o + seq;
  pb.table = table + static_cast<size_t>(b) * pps;
  pb.kvh = blockIdx.y;
  pb.g = H / KVH;
  pb.r0 = blockIdx.x * rtt::kTileR;
  pb.rows = S * pb.g;
  pb.H = H;
  pb.D = D;
  pb.P = P;
  pb.ps = ps;
  pb.start = max(positions[b], 0);
  // the tile's last row s sees keys up to positions[b] + s; a span that
  // ends past this sequence's table reads no page beyond its own row
  const int last_row = min(pb.r0 + rtt::kTileR, pb.rows) - 1;
  const int key_end = min(pb.start + last_row / pb.g + 1, pps * ps);
  rtt::attend_tile<T>(pb, D, key_end, scale);
}

}  // namespace

extern "C" int rtt_paged_attention_decode(const void* q, const void* k_pages,
                                          const void* v_pages, const int* table,
                                          const int* lengths, void* o, int B, int H, int KVH,
                                          int D, int P, int ps, int pps, float scale, int dtype,
                                          void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 || D > rtt::kTileMaxD || P <= 0 ||
      ps <= 0 || pps <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = decode_smem_bytes(H / KVH, D);
  const dim3 grid(KVH, B);
  RTT_DISPATCH_DTYPE(dtype, T, {
    // every pool row starts a multiple of D elements from the base
    if (!rtt::kv_layout_ok<T>(k_pages, v_pages, D)) return cudaErrorInvalidValue;
    cudaError_t err = rtt::allow_smem(paged_decode_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    paged_decode_kernel<T><<<grid, kDecThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), table, lengths, static_cast<T*>(o), H, KVH, D, P, ps,
        pps, scale);
  });
  return cudaGetLastError();
}

extern "C" int rtt_paged_attention_chunk(const void* q, const void* k_pages,
                                         const void* v_pages, const int* table, void* o, int C,
                                         int H, int KVH, int D, int P, int ps, int pps,
                                         int start, int total, float scale, int dtype,
                                         void* stream) {
  if (C <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 || D > rtt::kTileMaxD || P <= 0 ||
      ps <= 0 || pps <= 0 || start < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = rtt::tile_smem_bytes(D);
  const int rows = C * (H / KVH);
  const dim3 grid((rows + rtt::kTileR - 1) / rtt::kTileR, KVH);
  RTT_DISPATCH_DTYPE(dtype, T, {
    if (!rtt::kv_layout_ok<T>(k_pages, v_pages, D)) return cudaErrorInvalidValue;
    cudaError_t err = rtt::allow_smem(paged_chunk_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    paged_chunk_kernel<T><<<grid, rtt::kTileThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), table, static_cast<T*>(o), C, H, KVH, D, P, ps, pps,
        start, total, scale);
  });
  return cudaGetLastError();
}

extern "C" int rtt_paged_attention_verify(const void* q, const void* k_pages,
                                          const void* v_pages, const int* table,
                                          const int* positions, void* o, int B, int S, int H,
                                          int KVH, int D, int P, int ps, int pps, float scale,
                                          int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || KVH <= 0 || KVH > 65535 || H % KVH != 0 || D <= 0 ||
      D > rtt::kTileMaxD || P <= 0 || ps <= 0 || pps <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = rtt::tile_smem_bytes(D);
  const int rows = S * (H / KVH);
  const dim3 grid((rows + rtt::kTileR - 1) / rtt::kTileR, KVH, B);
  RTT_DISPATCH_DTYPE(dtype, T, {
    if (!rtt::kv_layout_ok<T>(k_pages, v_pages, D)) return cudaErrorInvalidValue;
    cudaError_t err = rtt::allow_smem(paged_verify_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    paged_verify_kernel<T><<<grid, rtt::kTileThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), table, positions, static_cast<T*>(o), S, H, KVH, D, P,
        ps, pps, scale);
  });
  return cudaGetLastError();
}
