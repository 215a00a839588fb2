// K2: causal flash-attention forward with GQA.
//
// Replaces ray_tpu/ops/attention.py `_fwd_kernel` (launched by
// `_flash_fwd_pallas`): o = softmax(q k^T * scale, causal) v per (b, head),
// kv head h // g, f32 online softmax, rows with no visible key give 0. With
// a non-null `lse` it also writes the reference's logsumexp residual
// lse [B, H, Tq] f32 (`return_lse=True`), which the backward kernels K3/K4
// (flash_attention_bwd.cu) read. With and without lse are two
// instantiations of one kernel (template flag kLse).
//
// Unlike the Pallas kernel, which needs T % block == 0 and T >= 128 (the
// JAX package falls back to XLA otherwise), this one takes every T: the
// ragged last tile is masked. It reads q/k/v of layout [B, T, H, D] through
// their strides, so callers never transpose, and writes a contiguous o.
//
// Which tile runs is decided by (dtype, D) alone:
//   bf16, D in {64, 128}: flash_fwd_wgmma_kernel, on the tensor cores;
//   f32, or any other D:  flash_fwd_fma_kernel, attend_tile's FMA loop
//                         (attention_tile.cuh).
//
// flash_fwd_wgmma_kernel<D, WG, kLse>: WG consumer warpgroups of 128
// threads, each owning 64 query rows (a CTA tile of 64 or 128 rows). Q is
// copied once and K/V tiles of 64 keys stream through a three-stage ring,
// all by 16-byte cp.async into 128-byte-swizzled bf16 shared memory
// (wgmma.cuh), two tiles ahead of the one being computed, with one barrier
// per tile. Per key tile a warpgroup issues S = Q K^T as D/16 SS wgmma
// m64n64k16 (both operands K-major), runs the online softmax on the
// accumulator fragment in registers (exp2 with scale * log2(e) folded in,
// running m and l in f32, the row max and O's rescale per thread, a row's
// values in the 4 threads of a quad), packs P to bf16 as the register-A
// operand, and adds P V with RS wgmma reading V from the same tile through
// the transpose (MN-major) bit. Only tiles that cross the diagonal or the
// ragged key end are masked. Query rows past Tq are zero-filled and never
// written; O / l goes out in bf16 through the Q tile, staged, in 16-byte
// stores; lse = m + log(l) in f32 with l == 0 counting as 1, -2e30 for a
// row with no visible key. The CTA takes 128 rows when that still gives
// one CTA per SM or more (ceil(Tq / 128) * H * B >= the SM count), else 64,
// so that the serving shape (T=256, 32 heads: 4 x 32 CTAs of 64 rows) fills
// the card. The grid runs the causal tiles with the most keys first.
//
// What bounds it: at the training shape (B=4, T=2048, 20 heads of 128) the
// work is 4 B H D T^2 / 2 operations on the tensor cores (bound 0.087 ms at
// 989 TFLOP/s); a warpgroup runs its two products and the softmax one
// after the other and waits for each product to drain, so none of the
// softmax hides under a product, and the kernel takes ~3.5x the bound
// (PERF.md).
// At the serving shape it is bound by bytes (0.0016 ms), and the launch and
// the one-wave grid dominate.

#include "attention_tile.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rtt::kNegInf;

// ------------------------------------------------ the FMA tile (f32, other D)

template <typename T>
struct FlashProblem {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  long long q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh;
  int b, h, kvh, q0, Tq, H, D;
  bool causal;

  __device__ const T* q_row(int r) const {
    const int t = q0 + r;
    return t < Tq ? q + b * q_sb + t * q_st + h * q_sh : nullptr;
  }
  __device__ size_t kv_offset(int key) const {
    return static_cast<size_t>(b * kv_sb + key * kv_st + kvh * kv_sh);
  }
  __device__ bool visible(int r, int key) const { return !causal || key <= q0 + r; }
  __device__ T* out_row(int r) const {
    const int t = q0 + r;
    return t < Tq ? o + (static_cast<size_t>(b) * Tq + t) * H * D + static_cast<size_t>(h) * D
                  : nullptr;
  }
};

template <typename T, bool kLse>
__global__ void __launch_bounds__(rtt::kTileThreads)
    flash_fwd_fma_kernel(const T* q, const T* k, const T* v, T* o, float* lse, int Tq, int Tk,
                         int H, int KVH, int D, long long q_sb, long long q_st, long long q_sh,
                         long long kv_sb, long long kv_st, long long kv_sh, int causal,
                         float scale) {
  FlashProblem<T> pb;
  pb.q = q;
  pb.k = k;
  pb.v = v;
  pb.o = o;
  pb.q_sb = q_sb;
  pb.q_st = q_st;
  pb.q_sh = q_sh;
  pb.kv_sb = kv_sb;
  pb.kv_st = kv_st;
  pb.kv_sh = kv_sh;
  pb.b = blockIdx.z;
  pb.h = blockIdx.y;
  pb.kvh = blockIdx.y / (H / KVH);
  pb.q0 = blockIdx.x * rtt::kTileR;
  pb.Tq = Tq;
  pb.H = H;
  pb.D = D;
  pb.causal = causal != 0;
  int key_end = Tk;
  if (pb.causal) key_end = min(Tk, min(Tq, pb.q0 + rtt::kTileR));
  if constexpr (kLse)
    rtt::attend_tile<T>(pb, D, key_end, scale,
                        lse + (static_cast<size_t>(pb.b) * H + pb.h) * Tq + pb.q0);
  else
    rtt::attend_tile<T>(pb, D, key_end, scale);
}

template <typename T, bool kLse>
cudaError_t launch_fma(dim3 grid, size_t smem, cudaStream_t s, const void* q, const void* k,
                       const void* v, void* o, float* lse, int Tq, int Tk, int H, int KVH, int D,
                       long long q_sb, long long q_st, long long q_sh, long long kv_sb,
                       long long kv_st, long long kv_sh, int causal, float scale) {
  cudaError_t err = rtt::allow_smem(flash_fwd_fma_kernel<T, kLse>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_fma_kernel<T, kLse><<<grid, rtt::kTileThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Tq, Tk, H, KVH, D, q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, causal,
      scale);
  return cudaSuccess;
}

// ------------------------------------------- the tensor-core tile (bf16, D 64/128)

constexpr int kKeys = 64;  // keys per K/V tile

template <int D, int WG>
struct FwdLayout {
  static constexpr int kRows = 64 * WG;
  static constexpr uint32_t kQ = kRows * D * 2;     // the Q tile, later O's staging
  static constexpr uint32_t kKV = kKeys * D * 2;    // one K or V tile
  static constexpr uint32_t kStage = 2 * kKV;       // K then V
  static constexpr size_t kSmem = kQ + 3 * kStage;  // Q + a ring of three stages
};

template <int D, int WG, bool kLse>
__global__ void __launch_bounds__(128 * WG, WG == 1 ? 2 : 1)
    flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int Tq, int Tk, int H, int KVH,
                           long long q_sb, long long q_st, long long q_sh, long long kv_sb,
                           long long kv_st, long long kv_sh, int causal, float scale) {
  namespace tc = rtt::tc;
  using L = FwdLayout<D, WG>;
  constexpr int kRows = L::kRows, kThreads = 128 * WG, kBlk = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = tc::aligned_smem(smem_raw);
  const uint32_t sQ = tc::smem_u32(smem), sKV = sQ + L::kQ;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the most keys first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const rtt::Rows qrows{q_sb, q_st, q_sh, b, h}, kvrows{kv_sb, kv_st, kv_sh, b, kvh};
  const int key_end = causal ? min(Tk, min(Tq, q0 + kRows)) : Tk;
  const int n_tiles = (key_end + kKeys - 1) / kKeys;
  // this warpgroup's rows [wq0, wq0 + 64) see the key tiles below wg_tiles
  const int wq0 = q0 + 64 * wg;
  const int wg_end = causal ? min(key_end, wq0 + 64) : key_end;
  const int wg_tiles = wq0 < Tq ? (wg_end + kKeys - 1) / kKeys : 0;

  const auto load_kv = [&](int t) {
    const uint32_t st = sKV + (t % 3) * L::kStage;
    tc::load_tile<kKeys, D, kThreads>(st, k, kvrows, t * kKeys, key_end, tid);
    tc::load_tile<kKeys, D, kThreads>(st + L::kKV, v, kvrows, t * kKeys, key_end, tid);
  };
  // copy groups: {Q, KV0}, {KV1}, then per iteration j {KV(j+2)}
  tc::load_tile<kRows, D, kThreads>(sQ, q, qrows, q0, Tq, tid);
  load_kv(0);
  tc::cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  tc::cp_async_commit();

  float acc[kBlk][32];
#pragma unroll
  for (int blk = 0; blk < kBlk; ++blk)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[blk][i] = 0.f;
  // running max (log2 units) and this thread's share of the running sum,
  // for its rows row0 and row0 + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sc2 = scale * tc::kLog2e;
  const int row0 = wq0 + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);

  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t sK = sKV + (j % 3) * L::kStage, sV = sK + L::kKV;
    tc::cp_async_wait<1>();
    tc::fence_async_proxy();
    __syncthreads();  // tile j in shared memory; every thread is done with tile j - 1
    if (j + 2 < n_tiles) load_kv(j + 2);
    tc::cp_async_commit();

    if (j < wg_tiles) {  // uniform over the warpgroup
      const int k0 = j * kKeys;
      float s[32];
      tc::qk_scores<kRows, D>(s, sQ, 64 * wg, sK);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= sc2;
      if (k0 + kKeys > key_end || (causal && k0 + kKeys - 1 > wq0)) {  // an edge tile
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = row0 + 8 * ((i >> 1) & 1);
          const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
          if (key >= key_end || (causal && key > row)) s[i] = kNegInf;
        }
      }
      float alpha[2];
      tc::softmax_tile(s, m, l, alpha);
      tc::pv_accumulate<kBlk>(acc, s, alpha, sV);
    }
  }

  // epilogue: the quad's sums, O / l into this warpgroup's rows of the Q
  // tile (its products have all completed), then 16-byte stores
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = tc::quad_sum(l[hh]);
    inv[hh] = l[hh] == 0.f ? 0.f : 1.f / l[hh];
    const int row = row0 + 8 * hh;
    if (kLse && (lane & 3) == 0 && row < Tq)
      lse[(static_cast<size_t>(b) * H + h) * Tq + row] =
          m[hh] > 0.5f * kNegInf ? m[hh] * tc::kLn2 + logf(l[hh] == 0.f ? 1.f : l[hh])
                                 : kNegInf;
  }
  tc::stage_rows<kRows, kBlk>(smem, 64 * wg, acc, inv, warp, lane);
  __syncthreads();
  const auto out_row = [&](int t) {
    return (static_cast<size_t>(b) * Tq + t) * H * D + static_cast<size_t>(h) * D;
  };
  tc::store_tile<kRows, D, kThreads>(smem, o, out_row, q0, Tq, tid);
}

template <int D, int WG, bool kLse>
cudaError_t launch_wgmma(cudaStream_t s, const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Tq, int Tk, int H, int KVH, long long q_sb,
                         long long q_st, long long q_sh, long long kv_sb, long long kv_st,
                         long long kv_sh, int causal, float scale) {
  constexpr int kRows = 64 * WG;
  const size_t smem = rtt::tc::smem_bytes(FwdLayout<D, WG>::kSmem);
  cudaError_t err = rtt::allow_smem(flash_fwd_wgmma_kernel<D, WG, kLse>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  flash_fwd_wgmma_kernel<D, WG, kLse><<<grid, 128 * WG, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, Tq, Tk, H, KVH, q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, causal,
      scale);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_wgmma_d(cudaStream_t s, const void* q, const void* k, const void* v, void* o,
                           float* lse, int B, int Tq, int Tk, int H, int KVH, long long q_sb,
                           long long q_st, long long q_sh, long long kv_sb, long long kv_st,
                           long long kv_sh, int causal, float scale) {
  const bool wide = static_cast<long long>((Tq + 127) / 128) * H * B >= rtt::sm_count();
#define RTT_FWD(WG, LSE)                                                                        \
  return launch_wgmma<D, WG, LSE>(s, q, k, v, o, lse, B, Tq, Tk, H, KVH, q_sb, q_st, q_sh,     \
                                  kv_sb, kv_st, kv_sh, causal, scale)
  if (wide) {
    if (lse) RTT_FWD(2, true);
    RTT_FWD(2, false);
  }
  if (lse) RTT_FWD(1, true);
  RTT_FWD(1, false);
#undef RTT_FWD
}

}  // namespace

// lse: null, or [B, H, Tq] f32 for the logsumexp residual
extern "C" int rtt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B,
                                   int Tq, int Tk, int H, int KVH, int D, long long q_sb,
                                   long long q_st, long long q_sh, long long kv_sb,
                                   long long kv_st, long long kv_sh, int causal, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 ||
      D > rtt::kTileMaxD)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == rtt::kBF16 && (D == 64 || D == 128)) {  // the tensor-core tile
    if (!rtt::kv_layout_ok<bf16>(k, v, D, kv_sb, kv_st, kv_sh) ||
        !rtt::kv_layout_ok<bf16>(q, q, D, q_sb, q_st, q_sh))
      return cudaErrorInvalidValue;
    cudaError_t err =
        D == 64 ? launch_wgmma_d<64>(s, q, k, v, o, l, B, Tq, Tk, H, KVH, q_sb, q_st, q_sh, kv_sb,
                                     kv_st, kv_sh, causal, scale)
                : launch_wgmma_d<128>(s, q, k, v, o, l, B, Tq, Tk, H, KVH, q_sb, q_st, q_sh,
                                      kv_sb, kv_st, kv_sh, causal, scale);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  const size_t smem = rtt::tile_smem_bytes(D);
  const dim3 grid((Tq + rtt::kTileR - 1) / rtt::kTileR, H, B);
  RTT_DISPATCH_DTYPE(dtype, T, {
    if (!rtt::kv_layout_ok<T>(k, v, D, kv_sb, kv_st, kv_sh)) return cudaErrorInvalidValue;
    cudaError_t err =
        l ? launch_fma<T, true>(grid, smem, s, q, k, v, o, l, Tq, Tk, H, KVH, D, q_sb, q_st,
                                q_sh, kv_sb, kv_st, kv_sh, causal, scale)
          : launch_fma<T, false>(grid, smem, s, q, k, v, o, l, Tq, Tk, H, KVH, D, q_sb, q_st,
                                 q_sh, kv_sb, kv_st, kv_sh, causal, scale);
    if (err != cudaSuccess) return err;
  });
  return cudaGetLastError();
}
