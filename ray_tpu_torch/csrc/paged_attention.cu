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
// reads each live key and value once and does 2*g flops per element read.
// Design (flash-decoding): each sequence's keys are cut into splits of
// kSplitKeys, and paged_decode_split_kernel runs one CTA per (split, kv
// head, sequence), grid (splits, KVH, B), where splits = ceil(pps * ps /
// kSplitKeys) comes from host-known sizes only: the host never reads
// lengths, which live on the card. A CTA whose split starts at or past
// min(lengths[b], pps * ps) exits at once. A live CTA copies its split's
// K and V rows into shared memory in bf16 (or f32), as it finds them in
// the pool, by 16-byte cp.async in two groups, K then V, so all of its
// bytes are in flight at once and the scores run while V still arrives;
// it then writes f32 partials for its g query rows: the unnormalised
// O [g, D], the max m and the sum l. paged_decode_combine_kernel, one CTA
// per (head, sequence), reads the number of live splits from lengths and
// merges o = sum e^(m_i - M) O_i / sum e^(m_i - M) l_i; no live split (a
// length of 0) gives exactly 0. The two kernels run back to back on the
// caller's stream from the one C entry point, rather than the last CTA of
// a (sequence, kv head) merging behind an atomic counter: stream order
// alone makes the workspace safe for calls in flight one after another,
// and there is no counter to reset. The workspace (B * H * splits * (D + 2)
// f32) is the wrapper's, from PyTorch's caching allocator. Products run on
// the FMA pipes: g = 4 query rows are too few for wgmma's 64 rows, and at
// 2*g flops per element the FMA pipes outrun the bytes. Scores: a key per
// 8 lanes, each lane a slice of D against the rows' q slices held in
// registers, summed over the 8 lanes by a transposed butterfly that leaves
// one row per lane; P.V: a column pair per thread, two key parities.
// Rows are handled G at a time (G in 1, 2, 4, 8, the least >= g up to 8;
// wider groups take more grid rows).

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
#include "wgmma.cuh"

namespace {

constexpr int kSplitKeys = 128;  // keys per split of K5
constexpr int kDecThreads = 128;

// The G partial sums v[0..G) of this lane, summed over the 8 lanes of its
// group (sl = lane % 8): each xor step trades half of the values that are
// left with the partner, so lane sl ends with the sum of row
// sl >> (3 - log2 G), in 7 shuffles for G = 8 (in place of 24).
template <int N>
__device__ __forceinline__ void fold_half(float* v, int o, bool upper) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? v[i] : v[i + N / 2];
    const float keep = upper ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

template <int G>
__device__ __forceinline__ float lane8_row_sum(float (&v)[G], int sl) {
  if constexpr (G >= 2) fold_half<G>(v, 4, sl & 4);
  else v[0] += __shfl_xor_sync(0xffffffffu, v[0], 4);
  if constexpr (G >= 4) fold_half<G / 2>(v, 2, sl & 2);
  else v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  if constexpr (G >= 8) fold_half<G / 4>(v, 1, sl & 1);
  else v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  return v[0];
}

template <typename T>
size_t split_smem_bytes(int G, int D) {
  // K [keys][D + 16 B of pad], V [keys][D], P^T [keys][G] f32, m/l [G]
  const size_t row = static_cast<size_t>(D) * sizeof(T);
  return kSplitKeys * (row + 16) + kSplitKeys * row + sizeof(float) * (kSplitKeys * G + 2 * G);
}

// Three CTAs to an SM, as the bf16 split's 72 KB of shared memory allow:
// without the bound ptxas kept G = 4 at 80 registers and spilled
template <typename T, int G>
__global__ void __launch_bounds__(kDecThreads, 3)
    paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages, const int* __restrict__ table,
                              const int* __restrict__ lengths, float* __restrict__ ws_o,
                              float* __restrict__ ws_ml, int H, int KVH, int D, int P, int ps,
                              int pps, int nsplit, float scale) {
  namespace tc = rtt::tc;
  constexpr int kVE = rtt::vec_elems<T>();
  constexpr int kCPT = rtt::kTileMaxD / kVE / 8;  // 16-byte chunks of a row per lane slice
  constexpr int kShift = G == 1 ? 3 : G == 2 ? 2 : G == 4 ? 1 : 0;
  const int split = blockIdx.x, b = blockIdx.z, g = H / KVH;
  const int n_rg = (g + G - 1) / G, kvh = blockIdx.y / n_rg, r0 = (blockIdx.y % n_rg) * G;
  const int len = min(lengths[b], pps * ps);  // no page past the sequence's table row
  const int s0 = split * kSplitKeys;
  if (s0 >= len) return;  // no live key: the combine reads no partial of this split
  const int n = min(kSplitKeys, len - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nC = D / kVE;
  const size_t row_bytes = static_cast<size_t>(D) * sizeof(T), kstride = row_bytes + 16;

  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* Ks = smem_raw;
  uint8_t* Vs = Ks + kSplitKeys * kstride;
  float* pt = reinterpret_cast<float*>(Vs + kSplitKeys * row_bytes);  // [key][G]
  float* m_s = pt + kSplitKeys * G;
  float* l_s = m_s + G;

  // the split's K rows, then its V rows, as two copy groups
  const int* trow = table + static_cast<size_t>(b) * pps;
  const auto copy_rows = [&](uint8_t* dst, size_t stride, const T* pool) {
    for (int idx = tid; idx < n * nC; idx += kDecThreads) {
      const int key = idx / nC, c = idx - key * nC, pos = s0 + key;
      const T* src = pool + ((static_cast<size_t>(kvh) * P + trow[pos / ps]) * ps + pos % ps) * D +
                     c * kVE;
      tc::cp_async16(tc::smem_u32(dst + key * stride + c * 16), src, true);
    }
    tc::cp_async_commit();
  };
  copy_rows(Ks, kstride, k_pages);
  copy_rows(Vs, row_bytes, v_pages);

  // this lane's slice of the G query rows: chunks sl, sl + 8, ... of each
  const int sl = tid & 7, kg = tid >> 3;
  float qf[G][kCPT][kVE];
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int jj = 0; jj < kCPT; ++jj) {
      const int c = sl + 8 * jj;
      const bool live = r0 + r < g && c < nC;
      const T* qr = q + (static_cast<size_t>(b) * H + kvh * g + r0 + r) * D + c * kVE;
#pragma unroll
      for (int e = 0; e < kVE; ++e) qf[r][jj][e] = live ? rtt::to_f32(qr[e]) : 0.f;
    }

  tc::cp_async_wait<1>();
  __syncthreads();  // K in shared memory
  // scores: key kg + 16 j, a slice of D per lane, summed over the 8 lanes
#pragma unroll
  for (int j = 0; j < kSplitKeys / 16; ++j) {
    if (16 * j >= n) break;  // uniform over the CTA
    const int key = kg + 16 * j;
    float acc[G];
#pragma unroll
    for (int r = 0; r < G; ++r) acc[r] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kCPT; ++jj) {
      const int c = sl + 8 * jj;
      if (c < nC) {
        float kf[kVE];
        rtt::unpack16<T>(*reinterpret_cast<const uint4*>(Ks + key * kstride + c * 16), kf);
#pragma unroll
        for (int r = 0; r < G; ++r)
#pragma unroll
          for (int e = 0; e < kVE; ++e) acc[r] = fmaf(qf[r][jj][e], kf[e], acc[r]);
      }
    }
    const float sum = lane8_row_sum<G>(acc, sl);
    if ((sl & ((1 << kShift) - 1)) == 0 && key < n) pt[key * G + (sl >> kShift)] = sum * scale;
  }
  __syncthreads();
  // softmax over the split, a warp per row; every key below n is visible
  for (int r = warp; r < G; r += kDecThreads / 32) {
    float x[kSplitKeys / 32], mx = rtt::kNegInf;
#pragma unroll
    for (int i = 0; i < kSplitKeys / 32; ++i) {
      const int key = lane + 32 * i;
      x[i] = key < n ? pt[key * G + r] : rtt::kNegInf;
      mx = fmaxf(mx, x[i]);
    }
    mx = rtt::warp_max(mx);
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kSplitKeys / 32; ++i) {
      const int key = lane + 32 * i;
      if (key < n) {
        const float p = expf(x[i] - mx);
        pt[key * G + r] = p;
        l += p;
      }
    }
    l = rtt::warp_sum(l);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = l;
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // V and P^T in shared memory
  // O += P V: columns 2 cp, 2 cp + 1 per thread, keys of parity kp
  const int cp = tid & 63, kp = tid >> 6;
  const bool has_col = 2 * cp < D;
  float o[G][2];
#pragma unroll
  for (int r = 0; r < G; ++r) o[r][0] = o[r][1] = 0.f;
  if (has_col) {
#pragma unroll 4
    for (int key = kp; key < n; key += 2) {
      const T* vr = reinterpret_cast<const T*>(Vs + key * row_bytes) + 2 * cp;
      const float v0 = rtt::to_f32(vr[0]), v1 = rtt::to_f32(vr[1]);
      const float* pr = pt + key * G;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        o[r][0] = fmaf(pr[r], v0, o[r][0]);
        o[r][1] = fmaf(pr[r], v1, o[r][1]);
      }
    }
  }
  // the two parities summed through shared memory (K's rows are free)
  float* red = reinterpret_cast<float*>(Ks);
  if (kp == 1 && has_col)
#pragma unroll
    for (int r = 0; r < G; ++r) {
      red[r * D + 2 * cp] = o[r][0];
      red[r * D + 2 * cp + 1] = o[r][1];
    }
  __syncthreads();
  const size_t part0 = (static_cast<size_t>(b) * H + kvh * g + r0) * nsplit + split;
  if (kp == 0 && has_col)
#pragma unroll
    for (int r = 0; r < G; ++r)
      if (r0 + r < g) {
        float* dst = ws_o + (part0 + static_cast<size_t>(r) * nsplit) * D + 2 * cp;
        dst[0] = o[r][0] + red[r * D + 2 * cp];
        dst[1] = o[r][1] + red[r * D + 2 * cp + 1];
      }
  if (tid < G && r0 + tid < g) {
    float* ml = ws_ml + (part0 + static_cast<size_t>(tid) * nsplit) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// o[b, h] = sum_i e^(m_i - M) O_i / sum_i e^(m_i - M) l_i over the live
// splits of sequence b; none (length 0) gives exactly 0
template <typename T>
__global__ void __launch_bounds__(rtt::kTileMaxD)
    paged_decode_combine_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
                                const int* __restrict__ lengths, T* __restrict__ o, int H, int D,
                                int nsplit, int max_len) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(lengths[b], max_len);
  const int live = len > 0 ? (len + kSplitKeys - 1) / kSplitKeys : 0;
  const size_t row = static_cast<size_t>(b) * H + h;
  const float* ml = ws_ml + row * nsplit * 2;
  const float* po = ws_o + row * nsplit * D + d;
  float M = rtt::kNegInf;
  for (int i = 0; i < live; ++i) M = fmaxf(M, ml[2 * i]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < live; ++i) {
    const float w = expf(ml[2 * i] - M);
    den = fmaf(w, ml[2 * i + 1], den);
    if (d < D) num = fmaf(w, po[static_cast<size_t>(i) * D], num);
  }
  if (d < D) o[row * D + d] = rtt::from_f32<T>(den > 0.f ? num / den : 0.f);
}

template <typename T, int G>
cudaError_t launch_decode(cudaStream_t s, const void* q, const void* k_pages, const void* v_pages,
                          const int* table, const int* lengths, void* o, float* ws, int B, int H,
                          int KVH, int D, int P, int ps, int pps, int nsplit, float scale) {
  const size_t smem = split_smem_bytes<T>(G, D);
  cudaError_t err = rtt::allow_smem(paged_decode_split_kernel<T, G>, smem);
  if (err != cudaSuccess) return err;
  const int n_rg = (H / KVH + G - 1) / G;
  float* ws_ml = ws + static_cast<size_t>(B) * H * nsplit * D;
  paged_decode_split_kernel<T, G><<<dim3(nsplit, KVH * n_rg, B), kDecThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      table, lengths, ws, ws_ml, H, KVH, D, P, ps, pps, nsplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<T><<<dim3(H, B), rtt::kTileMaxD, 0, s>>>(
      ws, ws_ml, lengths, static_cast<T*>(o), H, D, nsplit, pps * ps);
  return cudaSuccess;
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

// ws: f32 scratch of ws_floats >= B * H * splits * (D + 2), splits =
// ceil(pps * ps / kSplitKeys): the splits' partial O, then their (m, l)
extern "C" int rtt_paged_attention_decode(const void* q, const void* k_pages,
                                          const void* v_pages, const int* table,
                                          const int* lengths, void* o, void* ws,
                                          long long ws_floats, int B, int H, int KVH, int D,
                                          int P, int ps, int pps, float scale, int dtype,
                                          void* stream) {
  if (B <= 0 || B > 65535 || KVH <= 0 || H % KVH != 0 || D <= 0 || D > rtt::kTileMaxD ||
      P <= 0 || ps <= 0 || pps <= 0)
    return cudaErrorInvalidValue;
  const int nsplit = (pps * ps + kSplitKeys - 1) / kSplitKeys;
  const int g = H / KVH, G = g >= 8 ? 8 : g >= 4 ? 4 : g >= 2 ? 2 : 1;
  if (ws_floats < static_cast<long long>(B) * H * nsplit * (D + 2) ||
      static_cast<long long>(KVH) * ((g + G - 1) / G) > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
#define RTT_DECODE(GG)                                                                     \
  err = launch_decode<T, GG>(s, q, k_pages, v_pages, table, lengths, o, w, B, H, KVH, D, P, \
                             ps, pps, nsplit, scale)
  RTT_DISPATCH_DTYPE(dtype, T, {
    // every pool row starts a multiple of D elements from the base
    if (!rtt::kv_layout_ok<T>(k_pages, v_pages, D)) return cudaErrorInvalidValue;
    cudaError_t err;
    if (G == 8) RTT_DECODE(8);
    else if (G == 4) RTT_DECODE(4);
    else if (G == 2) RTT_DECODE(2);
    else RTT_DECODE(1);
    if (err != cudaSuccess) return err;
  });
#undef RTT_DECODE
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
