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
// O [g, D], the max m and the sum l. paged_combine_kernel (shared with K7),
// one CTA per (head, sequence), reads the number of live splits from lengths and
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
// ceil(total / ps) pages are read. start and total are the two int32 of
// `meta` on the card, which every CTA reads itself (the reference's scalar
// prefetch `meta_ref`), so one captured launch serves every chunk of a
// prompt: the grid depends on C alone. K7 `rtt_paged_attention_verify` replaces
// `_verify_kernel` (launched by `_verify_pallas`): the speculative-verify
// span, S = k + 1 query rows per sequence for the whole batch in one
// launch; key j is visible to row s of sequence b iff j <= positions[b] + s
// (negative positions count as 0), and no key past the sequence's own
// table row (pps pages) is read. Each CTA reads positions[b] itself, so a
// verify round needs no readback before the launch. The TPU wrappers
// transpose q to [.., KVH, rows, D] so that a block holds one kv head's
// rows; here row R = c * g + gi of a kv head is position c, head kvh * g +
// gi of [.., H, D], indexed in place, so each K/V byte read serves all g
// heads and no copy is made.
//
// bf16 at head dim 64/128 (the engine's) runs both on one tensor-core tile,
// paged_tile below: K2's flash_fwd_wgmma_kernel (flash_attention.cu) with
// GQA-packed rows, keys looked up through the page table once per tile, and
// the per-row mask. f32 and other head dims keep the FMA tile of
// attention_tile.cuh (paged_chunk_fma_kernel, paged_verify_fma_kernel).
// - K6 `paged_chunk_wgmma_kernel<D, WG>`: grid (1, row tiles x KVH), the
//   tiles with the most keys first; 128 rows a CTA (two warpgroups sharing
//   the K/V ring) when that still gives one CTA an SM, else 64. Bound:
//   operations at the engine's C = 256 (the causal (row, key) pairs on the
//   tensor cores); the grid is one wave, each CTA walking up to ~800 keys.
// - K7 `paged_verify_wgmma_kernel<D>` + `paged_combine_kernel<bf16>`: split-KV,
//   as K5. Bound: bytes (each live K/V row once per kv head); the S * g = 20
//   live rows of a 64-row tile cost tensor-core time that is free beside
//   the bytes, so what the kernel needs is CTAs in flight: each sequence's
//   keys [0, pps * ps) are cut into splits of kVerifySplitKeys, grid (splits,
//   row tiles x KVH, B), the number of splits from host-known sizes only; a
//   CTA whose split starts past what its tile's last row sees exits at once;
//   a live CTA writes f32 partials (O, m, l) of its rows into the wrapper's
//   workspace and the combine kernel, launched next from the same entry
//   point on the same stream, merges each row's live splits, which it counts
//   from positions on the card.

#include <climits>

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

// The merge of split partials, for K5 and K7: o[row] = sum_i e^(m_i - M)
// O_i / sum_i e^(m_i - M) l_i over the live splits of row (b, s, h), one CTA
// per row, grid (H, S, B). A row's key count is read on the card:
// min(lengths[b], max_len) for K5 (S = 1, span = 0) and
// min(max(positions[b], 0) + s + 1, max_len) for K7 (span = 1); its live
// splits are the first ceil(count / split_keys). None (a length of 0) gives
// exactly 0.
template <typename T>
__global__ void __launch_bounds__(rtt::kTileMaxD)
    paged_combine_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
                         const int* __restrict__ counts, T* __restrict__ o, int S, int H, int D,
                         int nsplit, int split_keys, int max_len, int span) {
  const int h = blockIdx.x, s = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int len = min(span ? max(counts[b], 0) + s + 1 : counts[b], max_len);
  const int live = len > 0 ? (len + split_keys - 1) / split_keys : 0;
  const size_t row = (static_cast<size_t>(b) * S + s) * H + h;
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
  paged_combine_kernel<T><<<dim3(H, 1, B), rtt::kTileMaxD, 0, s>>>(
      ws, ws_ml, lengths, static_cast<T*>(o), 1, H, D, nsplit, kSplitKeys, pps * ps, 0);
  return cudaSuccess;
}

// ------------------------------------ K6 and K7 on the tensor cores (bf16, D 64/128)

using bf16 = __nv_bfloat16;

constexpr int kTileKeys = 64;          // keys per K/V tile
constexpr int kVerifySplitKeys = 128;  // keys per split of K7

template <int D, int WG, int STAGES>
struct PagedLayout {
  static constexpr int kRows = 64 * WG;
  static constexpr uint32_t kQ = kRows * D * 2;     // the Q tile, later O's staging
  static constexpr uint32_t kKV = kTileKeys * D * 2;
  static constexpr uint32_t kStage = 2 * kKV;       // K then V
  static constexpr uint32_t kRowIds = STAGES * kTileKeys * 4;  // each stage's pool rows
  static constexpr size_t kSmem = kQ + STAGES * kStage + kRowIds;
};

// One kv head's query rows of a [positions, H, D] block: row R = c g + gi
// is position c, head kvh g + gi (the reference's GQA packing), so each K/V
// byte serves all g heads of the kv head
struct GqaRows {
  int g, H, kvh, D;
  __device__ size_t kv_offset(int R) const {
    const int c = R / g;
    return (static_cast<size_t>(c) * H + kvh * g + (R - c * g)) * D;
  }
};

// A K/V tile's keys through the page table: the pool row of key k0 + i,
// staged at rows[i] in shared memory once per tile
template <int D>
struct StagedKeys {
  const int* rows;
  int k0;
  __device__ size_t kv_offset(int key) const {
    return static_cast<size_t>(rows[key - k0]) * D;
  }
};

struct PagedArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;             // the normalised output (K6), or
  float* ws_o;         // the splits' partial O (K7) and
  float* ws_ml;        // their (m, l)
  const int* table;    // [pps] (K6) or [B, pps] (K7)
  const int* positions;  // K7: each sequence's start, read on the card; null for K6
  const int* meta;     // K6: [start, total], read on the card; null for K7
  int S;               // query positions per sequence: C (K6) or S (K7)
  int H, KVH, P, ps, pps;
  int nsplit;          // K7: splits of kVerifySplitKeys keys per sequence
  float scale;
};

// The paged tile. A CTA owns kRows = 64 WG GQA-packed query rows of one kv
// head of one sequence (blockIdx.y: row tile and kv head, the tiles with
// the most keys first; blockIdx.z: the sequence) and walks its keys in
// tiles of 64, as flash_fwd_wgmma_kernel does: a ring of STAGES K/V stages
// filled by cp.async, S = Q K^T (SS), the online softmax on the fragment,
// O += P V (RS). Each stage's keys are looked up in the page table once, by
// 64 threads, into a ring of pool rows in shared memory, one tile before
// the copies that read them. Row R sees key j iff j <= start + R / g, j <
// total and j < pps * ps (no page past the sequence's table row); only
// tiles that cross a row's bound or the key end are masked. Without
// kSplit the CTA walks keys [0, key_end) and writes O / l in bf16 (0 for a
// row with no visible key). With kSplit, CTA blockIdx.x takes the keys of
// split x only (kVerifySplitKeys each), exits at once when no row of its
// tile sees the first of them, and writes f32 partials of its rows: the
// unnormalised O, m in natural-log units, and l.
template <int D, int WG, int STAGES, bool kSplit>
__device__ __forceinline__ void paged_tile(const PagedArgs& a) {
  namespace tc = rtt::tc;
  using L = PagedLayout<D, WG, STAGES>;
  constexpr int kRows = L::kRows, kThreads = 128 * WG, kBlk = D / 64;
  extern __shared__ __align__(16) uint8_t tile_smem[];
  uint8_t* smem = tc::aligned_smem(tile_smem);
  const uint32_t sQ = tc::smem_u32(smem), sKV = sQ + L::kQ;
  int* row_ids = reinterpret_cast<int*>(smem + L::kQ + STAGES * L::kStage);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = a.H / a.KVH, rows = a.S * g, n_rt = (rows + kRows - 1) / kRows;
  const int kvh = blockIdx.y % a.KVH, r0 = (n_rt - 1 - blockIdx.y / a.KVH) * kRows;
  const int b = blockIdx.z;
  const int* table = a.table + static_cast<size_t>(b) * a.pps;
  const int start = a.positions ? max(a.positions[b], 0) : a.meta[0];
  const int total = a.positions ? INT_MAX : a.meta[1];
  // the keys any row of the tile sees
  const int key_end = min(min(total, start + (min(r0 + kRows, rows) - 1) / g + 1), a.pps * a.ps);
  int k_begin = 0, k_stop = key_end;
  if constexpr (kSplit) {
    k_begin = blockIdx.x * kVerifySplitKeys;
    if (k_begin >= key_end) return;  // the combine reads no partial of this split
    k_stop = min(key_end, k_begin + kVerifySplitKeys);
  }
  const int n_tiles = k_stop > k_begin ? (k_stop - k_begin + kTileKeys - 1) / kTileKeys : 0;
  // this warpgroup's rows [wr0, wr0 + 64) see keys below wg_stop
  const int wr0 = r0 + 64 * wg;
  const int wg_stop =
      wr0 < rows ? min(k_stop, start + (min(wr0 + 64, rows) - 1) / g + 1) : k_begin;

  const auto stage_rows_of = [&](int t) {  // tile t's pool rows, one key per thread
    if (tid < kTileKeys) {
      const int key = k_begin + t * kTileKeys + tid;
      row_ids[(t % STAGES) * kTileKeys + tid] =
          key < k_stop ? (kvh * a.P + table[key / a.ps]) * a.ps + key % a.ps : 0;
    }
  };
  const auto load_kv = [&](int t) {
    const uint32_t st = sKV + (t % STAGES) * L::kStage;
    const int k0 = k_begin + t * kTileKeys;
    const StagedKeys<D> keys{row_ids + (t % STAGES) * kTileKeys, k0};
    tc::load_tile<kTileKeys, D, kThreads>(st, a.k, keys, k0, k_stop, tid);
    tc::load_tile<kTileKeys, D, kThreads>(st + L::kKV, a.v, keys, k0, k_stop, tid);
  };
  const size_t seq = static_cast<size_t>(b) * a.S * a.H * D;
  const GqaRows qrows{g, a.H, kvh, D};
  // pool rows of the first STAGES tiles; then copy groups {Q, KV0},
  // {KV1} .. {KV(STAGES - 2)}, and per iteration j {KV(j + STAGES - 1)},
  // whose pool rows were staged in iteration j - 1 (slot t % STAGES is
  // rewritten only after the barrier that follows its last reader)
  for (int t = 0; t < STAGES && t < n_tiles; ++t) stage_rows_of(t);
  __syncthreads();
  tc::load_tile<kRows, D, kThreads>(sQ, a.q + seq, qrows, r0, rows, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    tc::cp_async_commit();
  }

  float acc[kBlk][32];
#pragma unroll
  for (int blk = 0; blk < kBlk; ++blk)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[blk][i] = 0.f;
  float m[2] = {rtt::kNegInf, rtt::kNegInf}, l[2] = {0.f, 0.f};
  const float sc2 = a.scale * tc::kLog2e;
  const int row0 = wr0 + 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  // the last key each of the thread's two rows sees
  const int bound[2] = {start + row0 / g, start + (row0 + 8) / g};

  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t sK = sKV + (j % STAGES) * L::kStage, sV = sK + L::kKV;
    tc::cp_async_wait<STAGES - 2>();
    tc::fence_async_proxy();
    __syncthreads();  // tile j in shared memory; every thread is done with tile j - 1
    if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1);
    tc::cp_async_commit();
    if (j + STAGES < n_tiles) stage_rows_of(j + STAGES);

    const int k0 = k_begin + j * kTileKeys;
    if (k0 < wg_stop) {  // uniform over the warpgroup
      float s[32];
      tc::qk_scores<kRows, D>(s, sQ, 64 * wg, sK);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= sc2;
      // an edge tile: past the key end (zero-filled keys would score 0) or
      // past the bound of the warpgroup's first row
      if (k0 + kTileKeys > k_stop || k0 + kTileKeys - 1 > start + wr0 / g) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
          if (key >= k_stop || key > bound[(i >> 1) & 1]) s[i] = rtt::kNegInf;
        }
      }
      float alpha[2];
      tc::softmax_tile(s, m, l, alpha);
      tc::pv_accumulate<kBlk>(acc, s, alpha, sV);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = tc::quad_sum(l[hh]);
  if constexpr (kSplit) {
    // f32 partials of the rows below `rows`, at ((b S + s) H + h) nsplit + x
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int R = row0 + 8 * hh;
      if (R >= rows) continue;
      const int c = R / g;
      const size_t part =
          ((static_cast<size_t>(b) * a.S + c) * a.H + kvh * g + (R - c * g)) * a.nsplit +
          blockIdx.x;
      float* po = a.ws_o + part * D + col0;
#pragma unroll
      for (int blk = 0; blk < kBlk; ++blk)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = 4 * jj + 2 * hh;
          *reinterpret_cast<float2*>(po + 64 * blk + 8 * jj) =
              make_float2(acc[blk][i], acc[blk][i + 1]);
        }
      if ((lane & 3) == 0) {
        a.ws_ml[2 * part] = m[hh] * tc::kLn2;
        a.ws_ml[2 * part + 1] = l[hh];
      }
    }
  } else {
    // O / l into this warpgroup's rows of the Q tile (its products have all
    // completed), then 16-byte stores of the rows below `rows`. With no key
    // tile, no wait has covered Q's copies yet.
    if (n_tiles == 0) {
      tc::cp_async_wait<0>();
      __syncthreads();
    }
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) inv[hh] = l[hh] == 0.f ? 0.f : 1.f / l[hh];
    tc::stage_rows<kRows, kBlk>(smem, 64 * wg, acc, inv, warp, lane);
    __syncthreads();
    tc::store_tile<kRows, D, kThreads>(
        smem, a.o + seq, [&](int R) { return qrows.kv_offset(R); }, r0, rows, tid);
  }
}

// K6: one sequence's chunk, grid (1, row tiles x KVH)
template <int D, int WG>
__global__ void __launch_bounds__(128 * WG, WG == 1 ? 2 : 1)
    paged_chunk_wgmma_kernel(const PagedArgs a) {
  paged_tile<D, WG, 3, false>(a);
}

// K7: the verify span of every sequence as split-KV, grid (splits, row
// tiles x KVH, B); two stages hold a 128-key split's two tiles and keep
// the shared memory low enough for two CTAs an SM at D = 128
constexpr int kVerifyStages = 2;

template <int D>
__global__ void __launch_bounds__(128, 2) paged_verify_wgmma_kernel(const PagedArgs a) {
  paged_tile<D, 1, kVerifyStages, true>(a);
}

template <int D>
cudaError_t launch_chunk_wgmma(cudaStream_t s, const PagedArgs& a) {
  const int rows = a.S * (a.H / a.KVH);
  // 128 rows a CTA when that still gives one CTA an SM or more, as K2
  const bool wide = static_cast<long long>((rows + 127) / 128) * a.KVH >= rtt::sm_count();
  const auto launch = [&](auto kernel, int wg, size_t tiles) {
    const size_t smem = rtt::tc::smem_bytes(tiles);
    cudaError_t err = rtt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const int n_rt = (rows + 64 * wg - 1) / (64 * wg);
    kernel<<<dim3(1, n_rt * a.KVH, 1), 128 * wg, smem, s>>>(a);
    return cudaSuccess;
  };
  if (wide) return launch(paged_chunk_wgmma_kernel<D, 2>, 2, PagedLayout<D, 2, 3>::kSmem);
  return launch(paged_chunk_wgmma_kernel<D, 1>, 1, PagedLayout<D, 1, 3>::kSmem);
}

template <int D>
cudaError_t launch_verify_wgmma(cudaStream_t s, const PagedArgs& a, int B) {
  const size_t smem = rtt::tc::smem_bytes(PagedLayout<D, 1, kVerifyStages>::kSmem);
  cudaError_t err = rtt::allow_smem(paged_verify_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int n_rt = (a.S * (a.H / a.KVH) + 63) / 64;
  paged_verify_wgmma_kernel<D><<<dim3(a.nsplit, n_rt * a.KVH, B), 128, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<bf16><<<dim3(a.H, a.S, B), rtt::kTileMaxD, 0, s>>>(
      a.ws_o, a.ws_ml, a.positions, a.o, a.S, a.H, D, a.nsplit, kVerifySplitKeys, a.pps * a.ps,
      1);
  return cudaSuccess;
}

// ------------------------------------------------- K6 and K7 on the FMA tile

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
    paged_chunk_fma_kernel(const T* q, const T* k_pages, const T* v_pages, const int* table,
                           const int* meta, T* o, int C, int H, int KVH, int D, int P, int ps,
                           int pps, float scale) {
  const int start = meta[0], total = meta[1];
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
    paged_verify_fma_kernel(const T* q, const T* k_pages, const T* v_pages, const int* table,
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

// bf16 at head_dim 64 or 128 runs on the tensor cores
bool tensor_core(int dtype, int D) { return dtype == rtt::kBF16 && (D == 64 || D == 128); }

// the wgmma loaders keep a key's pool row, (kvh P + page) ps + slot, in an int
bool pool_rows_fit(int KVH, int P, int ps) {
  return static_cast<long long>(KVH) * P * ps <= INT_MAX;
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

// meta: two int32 on the card, [start, total]
extern "C" int rtt_paged_attention_chunk(const void* q, const void* k_pages,
                                         const void* v_pages, const int* table,
                                         const int* meta, void* o, int C, int H, int KVH, int D,
                                         int P, int ps, int pps, float scale, int dtype,
                                         void* stream) {
  if (C <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 || D > rtt::kTileMaxD || P <= 0 ||
      ps <= 0 || pps <= 0 || meta == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core(dtype, D)) {
    if (!rtt::kv_layout_ok<bf16>(k_pages, v_pages, D) || !rtt::kv_layout_ok<bf16>(q, o, D) ||
        !pool_rows_fit(KVH, P, ps) || static_cast<long long>(C) * H / 64 + KVH > 65535)
      return cudaErrorInvalidValue;
    PagedArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
                static_cast<const bf16*>(v_pages), static_cast<bf16*>(o), nullptr, nullptr,
                table, nullptr, meta, C, H, KVH, P, ps, pps, 1, scale};
    cudaError_t err = D == 64 ? launch_chunk_wgmma<64>(s, a) : launch_chunk_wgmma<128>(s, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  const size_t smem = rtt::tile_smem_bytes(D);
  const int rows = C * (H / KVH);
  const dim3 grid((rows + rtt::kTileR - 1) / rtt::kTileR, KVH);
  RTT_DISPATCH_DTYPE(dtype, T, {
    if (!rtt::kv_layout_ok<T>(k_pages, v_pages, D)) return cudaErrorInvalidValue;
    cudaError_t err = rtt::allow_smem(paged_chunk_fma_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    paged_chunk_fma_kernel<T><<<grid, rtt::kTileThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), table, meta, static_cast<T*>(o), C, H, KVH, D, P, ps,
        pps, scale);
  });
  return cudaGetLastError();
}

// ws: on the tensor-core path (bf16, D 64/128), f32 scratch of ws_floats >=
// B * S * H * splits * (D + 2), splits = ceil(pps * ps / kVerifySplitKeys):
// the splits' partial O, then their (m, l); unused otherwise
extern "C" int rtt_paged_attention_verify(const void* q, const void* k_pages,
                                          const void* v_pages, const int* table,
                                          const int* positions, void* o, void* ws,
                                          long long ws_floats, int B, int S, int H, int KVH,
                                          int D, int P, int ps, int pps, float scale, int dtype,
                                          void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || S > 65535 || KVH <= 0 || KVH > 65535 || H % KVH != 0 ||
      D <= 0 || D > rtt::kTileMaxD || P <= 0 || ps <= 0 || pps <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core(dtype, D)) {
    const int nsplit = (pps * ps + kVerifySplitKeys - 1) / kVerifySplitKeys;
    if (!rtt::kv_layout_ok<bf16>(k_pages, v_pages, D) || !rtt::kv_layout_ok<bf16>(q, o, D) ||
        !pool_rows_fit(KVH, P, ps) ||
        ws_floats < static_cast<long long>(B) * S * H * nsplit * (D + 2) ||
        static_cast<long long>(S) * H / 64 + KVH > 65535)
      return cudaErrorInvalidValue;
    float* w = static_cast<float*>(ws);
    PagedArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
                static_cast<const bf16*>(v_pages), static_cast<bf16*>(o), w,
                w + static_cast<size_t>(B) * S * H * nsplit * D, table, positions, nullptr, S,
                H, KVH, P, ps, pps, nsplit, scale};
    cudaError_t err =
        D == 64 ? launch_verify_wgmma<64>(s, a, B) : launch_verify_wgmma<128>(s, a, B);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  const size_t smem = rtt::tile_smem_bytes(D);
  const int rows = S * (H / KVH);
  const dim3 grid((rows + rtt::kTileR - 1) / rtt::kTileR, KVH, B);
  RTT_DISPATCH_DTYPE(dtype, T, {
    if (!rtt::kv_layout_ok<T>(k_pages, v_pages, D)) return cudaErrorInvalidValue;
    cudaError_t err = rtt::allow_smem(paged_verify_fma_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    paged_verify_fma_kernel<T><<<grid, rtt::kTileThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), table, positions, static_cast<T*>(o), S, H, KVH, D, P,
        ps, pps, scale);
  });
  return cudaGetLastError();
}
