// K3 and K4: the causal flash-attention backward (flash-2) with GQA.
//
// Replaces ray_tpu/ops/attention.py `_dq_kernel` (K3) and `_dkv_kernel`
// (K4), both launched by `_flash_bwd_pallas`. With P = exp(S - lse),
// S = q k^T * scale (masked scores at -2e30), dP = dO v^T and
// dS = P * (dP - delta) * scale, where lse comes from the forward (K2) and
// delta = rowsum(dO * O) - dlse is computed by the caller:
//   K3: dQ = dS K         one CTA per (b, q head, q tile), walking the key
//                          tiles up to the diagonal;
//   K4: dK = dS^T Q,      one CTA per (b, kv head, 64-key tile), looping over
//       dV = P^T dO        the g q heads of its group and the q tiles at and
//                          below the diagonal, so the sum over the group
//                          happens in registers (the reference writes a
//                          [B, H, T, D] f32 transient and sums it outside).
//
// Layout as K2: q, dO [B, Tq, H, D] sharing one set of strides, k, v
// [B, Tk, KVH, D] sharing another; lse and delta [B, H, Tq] f32 contiguous;
// dq [B, Tq, H, D] and dk, dv [B, Tk, KVH, D] written contiguous in the input
// dtype. Any Tq, Tk: ragged tiles are masked. All sums are f32.
//
// Which kernel runs is decided by (dtype, D) alone, for K3 and K4 alike:
//   bf16, D in {64, 128}: flash_bwd_dq_wgmma_kernel / flash_bwd_dkv_wgmma_kernel,
//                         on the tensor cores;
//   f32, or any other D:  flash_bwd_dq_fma_kernel / flash_bwd_dkv_fma_kernel,
//                         on the FMA pipes (4x4 register tiles over f32
//                         shared memory).
//
// flash_bwd_dq_wgmma_kernel<D>: K2's tensor-core skeleton
// (flash_attention.cu, wgmma.cuh) for one warpgroup of 128 threads owning
// 64 query rows, two CTAs to an SM. Q and dO stay resident in
// 128-byte-swizzled bf16 shared memory, lse and delta of the thread's two
// rows in registers; K/V tiles of 64 keys stream through a two-stage
// cp.async ring. Per key tile up to the diagonal the warpgroup issues
// S = Q K^T and dP = dO V^T as SS wgmma (both K-major) in one group, forms
// P = exp2(S scale log2(e) - lse log2(e)) and dS = P (dP - delta) scale on
// the accumulator fragments (masked only on tiles that cross the diagonal
// or the ragged key end), packs dS to bf16 as the register-A operand and
// adds dS K with RS wgmma that reads K from the same shared-memory tile S
// read, through the transpose (MN-major) bit. dQ is written in bf16
// through the Q tile in 16-byte stores. (Two warpgroups sharing a 128-row
// tile, as K2 does, ran slower at the training shape on the H100.)
//
// flash_bwd_dkv_wgmma_kernel<D>: the same skeleton with the roles
// swapped. One warpgroup owns 64 keys (wgmma M = keys), two CTAs to an
// SM; its K and V tiles stay resident, and the (q head of the group, q tile) pairs at and below
// the diagonal stream through a two-stage cp.async ring whose stages hold
// Q, dO and the tile's lse and delta (64 f32 each). Per stage it issues
// S^T = K Q^T and dP^T = V dO^T as SS wgmma in one group, forms P^T on the
// fragments (lse indexes the fragment's columns, so it is read from the
// stage, not held per thread) and dS^T = P^T (dP^T - delta) scale, packs
// both to bf16 as register-A operands, and issues dV += P^T dO and
// dK += dS^T Q in one group; both read dO and Q MN-major from the bytes
// S^T and dP^T read K-major, and one wait ends the stage. Masking
// runs only on stages that cross the diagonal, the ragged key end or the
// end of Tq. The GQA sum stays in the f32 accumulators; dK and dV go out in
// bf16 through the K and V tiles in 16-byte stores. The grid runs key tile
// 0, which sees the most q tiles, first. (Two warpgroups of 64 keys
// sharing one ring ran slower on the H100; PERF.md.)
//
// What bounds them: on the tensor cores K3 does 6 B H D T^2 / 2 and K4
// 8 B H D T^2 / 2 operations at the training shape (bounds 0.130 and
// 0.174 ms); like K2, each warpgroup runs its products and the elementwise
// work one after the other, so the elementwise work does not hide under
// the products.

#include "attention_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kR = rtt::kTileR;   // query rows per tile
constexpr int kK = rtt::kTileK;   // keys per tile
constexpr int kThreads = rtt::kTileThreads;
constexpr int kMaxD = rtt::kTileMaxD;
constexpr int kCols = kMaxD / 16;
static_assert(kR == kK, "K4 finds the q tiles below the diagonal by tile index");

using rtt::kNegInf;

using rtt::Rows;

inline size_t dq_smem_bytes(int D) {  // Q, dO, K, V [64][D+1]; dS [64][65]; lse, delta [64]
  return sizeof(float) * (4 * static_cast<size_t>(kR) * (D + 1) + kR * (kK + 1) + 2 * kR);
}

inline size_t dkv_smem_bytes(int D) {  // K, V, Q, dO [64][D+1]; P^T, dS^T [64][65]; lse, delta
  return sizeof(float) * (4 * static_cast<size_t>(kR) * (D + 1) + 2 * kK * (kR + 1) + 2 * kR);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_fma_kernel(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                        const float* delta, T* dq, int Tq, int Tk, int H, int KVH, int D,
                        long long q_sb, long long q_st, long long q_sh, long long kv_sb,
                        long long kv_st, long long kv_sh, int causal, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* Qs = smem;
  float* dOs = Qs + kR * Dp;
  float* Ks = dOs + kR * Dp;
  float* Vs = Ks + kK * Dp;
  float* dSs = Vs + kK * Dp;
  float* lse_s = dSs + kR * (kK + 1);
  float* dl_s = lse_s + kR;

  // the last q tiles see the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kR;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const Rows qrows{q_sb, q_st, q_sh, b, h};
  const Rows kvrows{kv_sb, kv_st, kv_sh, b, kvh};

  rtt::KVStager<T, kR, kThreads, kMaxD> stager;
  stager.fetch(qrows, q, dout, q0, Tq, D);
  stager.store(Qs, Dp, dOs, Dp, D);
  if (tid < kR) {
    const int t = q0 + tid;
    const size_t i = (static_cast<size_t>(b) * H + h) * Tq + t;
    lse_s[tid] = t < Tq ? lse[i] : 0.f;
    dl_s[tid] = t < Tq ? delta[i] : 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  int key_end = Tk;
  if (causal) key_end = min(Tk, min(Tq, q0 + kR));
  if (key_end > 0) stager.fetch(kvrows, k, v, 0, key_end, D);
  for (int k0 = 0; k0 < key_end; k0 += kK) {
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/dSs
    stager.store(Ks, Dp, Vs, Dp, D);
    __syncthreads();
    if (k0 + kK < key_end) stager.fetch(kvrows, k, v, k0 + kK, key_end, D);

    // S and dP for rows ty*4 + i, keys tx + 16*j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * Dp + d];
        ov[i] = dOs[(ty * 4 + i) * Dp + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * Dp + d];
        vv[j] = Vs[(tx + 16 * j) * Dp + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j, key = k0 + kk;
        const bool keep = key < key_end && (!causal || key <= q0 + r);
        // the reference's formula: a masked score is -2e30 before exp
        const float p = q0 + r < Tq ? expf((keep ? s[i][j] * scale : kNegInf) - lse_s[r]) : 0.f;
        dSs[r * (kK + 1) + kk] = p * (dp[i][j] - dl_s[r]) * scale;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * (kK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float kd = Ks[kk * Dp + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kd, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tq) continue;
    T* out = dq + (static_cast<size_t>(b) * Tq + t) * H * D + static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (d < D) out[d] = rtt::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_fma_kernel(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                         const float* delta, T* dk, T* dv, int Tq, int Tk, int H, int KVH, int D,
                         long long q_sb, long long q_st, long long q_sh, long long kv_sb,
                         long long kv_st, long long kv_sh, int causal, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* Ks = smem;
  float* Vs = Ks + kK * Dp;
  float* Qs = Vs + kK * Dp;
  float* dOs = Qs + kR * Dp;
  float* Pt = dOs + kR * Dp;       // P^T  [key][row]
  float* dSt = Pt + kK * (kR + 1);  // dS^T [key][row]
  float* lse_s = dSt + kK * (kR + 1);
  float* dl_s = lse_s + kR;

  const int k0 = blockIdx.x * kK, kvh = blockIdx.y, b = blockIdx.z;
  const int g = H / KVH;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const Rows kvrows{kv_sb, kv_st, kv_sh, b, kvh};

  rtt::KVStager<T, kR, kThreads, kMaxD> stager;
  stager.fetch(kvrows, k, v, k0, Tk, D);
  stager.store(Ks, Dp, Vs, Dp, D);

  // keys ty*4 + a, columns tx + 16*c
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  // under causal masking, rows before k0 see none of this tile's keys
  const int qt_first = causal ? k0 / kR : 0;
  const int n_qt = max(0, (Tq + kR - 1) / kR - qt_first);
  const int n_it = g * n_qt;  // (q head of the group, q tile) pairs
  auto rows_of = [&](int it) {
    return Rows{q_sb, q_st, q_sh, b, kvh * g + it / n_qt};
  };
  auto q0_of = [&](int it) { return (qt_first + it % n_qt) * kR; };
  if (n_it > 0) stager.fetch(rows_of(0), q, dout, q0_of(0), Tq, D);

  for (int it = 0; it < n_it; ++it) {
    const int hq = kvh * g + it / n_qt, q0 = q0_of(it);
    __syncthreads();  // the previous tile's readers are done with Qs/dOs/Pt/dSt/lse_s
    stager.store(Qs, Dp, dOs, Dp, D);
    if (tid < kR) {
      const int t = q0 + tid;
      const size_t i = (static_cast<size_t>(b) * H + hq) * Tq + t;
      lse_s[tid] = t < Tq ? lse[i] : 0.f;
      dl_s[tid] = t < Tq ? delta[i] : 0.f;
    }
    __syncthreads();
    if (it + 1 < n_it) stager.fetch(rows_of(it + 1), q, dout, q0_of(it + 1), Tq, D);

    // S and dP, transposed: keys ty*4 + a, rows tx + 16*c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        kv[a] = Ks[(ty * 4 + a) * Dp + d];
        vv[a] = Vs[(ty * 4 + a) * Dp + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qv[c] = Qs[(tx + 16 * c) * Dp + d];
        ov[c] = dOs[(tx + 16 * c) * Dp + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(kv[a], qv[c], s[a][c]);
          dp[a][c] = fmaf(vv[a], ov[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int kk = ty * 4 + a, key = k0 + kk;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = tx + 16 * c, row = q0 + r;
        const bool keep = key < Tk && (!causal || key <= row);
        const float p = row < Tq ? expf((keep ? s[a][c] * scale : kNegInf) - lse_s[r]) : 0.f;
        Pt[kk * (kR + 1) + r] = p;
        dSt[kk * (kR + 1) + r] = p * (dp[a][c] - dl_s[r]) * scale;
      }
    }
    __syncthreads();

    for (int r = 0; r < kR; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        p[a] = Pt[(ty * 4 + a) * (kR + 1) + r];
        ds[a] = dSt[(ty * 4 + a) * (kR + 1) + r];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float od = dOs[r * Dp + d], qd = Qs[r * Dp + d];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            dv_acc[a][c] = fmaf(p[a], od, dv_acc[a][c]);
            dk_acc[a][c] = fmaf(ds[a], qd, dk_acc[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty * 4 + a;
    if (key >= Tk) continue;
    const size_t off = (static_cast<size_t>(b) * Tk + key) * KVH * D + static_cast<size_t>(kvh) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[off + d] = rtt::from_f32<T>(dk_acc[a][c]);
        dv[off + d] = rtt::from_f32<T>(dv_acc[a][c]);
      }
    }
  }
}

// ----------------------------------------- K3 on the tensor cores (bf16, D 64/128)

using bf16 = __nv_bfloat16;
constexpr int kKeys = 64;  // keys per K/V tile

template <int D>
struct DqLayout {
  static constexpr int kRows = 64;                  // one warpgroup's query rows
  static constexpr uint32_t kQ = kRows * D * 2;     // Q, later dQ's staging; dO the same
  static constexpr uint32_t kKV = kKeys * D * 2;    // one K or V tile
  static constexpr uint32_t kStage = 2 * kKV;       // K then V
  static constexpr size_t kSmem = 2 * kQ + 2 * kStage;
};

template <int D>
__global__ void __launch_bounds__(128, 2)
    flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, int Tq, int Tk, int H, int KVH,
                              long long q_sb, long long q_st, long long q_sh, long long kv_sb,
                              long long kv_st, long long kv_sh, int causal, float scale) {
  namespace tc = rtt::tc;
  using L = DqLayout<D>;
  constexpr int kRows = L::kRows, kThreads = 128, kBlk = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = tc::aligned_smem(smem_raw);
  const uint32_t sQ = tc::smem_u32(smem), sdO = sQ + L::kQ, sKV = sdO + L::kQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the most keys first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const Rows qrows{q_sb, q_st, q_sh, b, h}, kvrows{kv_sb, kv_st, kv_sh, b, kvh};
  const int key_end = causal ? min(Tk, min(Tq, q0 + kRows)) : Tk;
  const int n_tiles = (key_end + kKeys - 1) / kKeys;

  tc::load_tile<kRows, D, kThreads>(sQ, q, qrows, q0, Tq, tid);
  tc::load_tile<kRows, D, kThreads>(sdO, dout, qrows, q0, Tq, tid);
  tc::cp_async_commit();
  tc::load_tile<kKeys, D, kThreads>(sKV, k, kvrows, 0, key_end, tid);
  tc::load_tile<kKeys, D, kThreads>(sKV + L::kKV, v, kvrows, 0, key_end, tid);
  tc::cp_async_commit();

  // lse (log2 units) and delta of the thread's rows row0 and row0 + 8; rows
  // past Tq read 0 and are never written
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const size_t i = (static_cast<size_t>(b) * H + h) * Tq + row;
    lse2[hh] = row < Tq ? lse[i] * tc::kLog2e : 0.f;
    dl[hh] = row < Tq ? delta[i] : 0.f;
  }
  const float sc2 = scale * tc::kLog2e;
  float acc[kBlk][32];
#pragma unroll
  for (int blk = 0; blk < kBlk; ++blk)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[blk][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t sK = sKV + (j & 1) * L::kStage, sV = sK + L::kKV;
    if (j + 1 < n_tiles) {
      const uint32_t nK = sKV + ((j + 1) & 1) * L::kStage;
      tc::load_tile<kKeys, D, kThreads>(nK, k, kvrows, (j + 1) * kKeys, key_end, tid);
      tc::load_tile<kKeys, D, kThreads>(nK + L::kKV, v, kvrows, (j + 1) * kKeys, key_end, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_async_proxy();
    __syncthreads();  // tile j (and Q, dO) in shared memory for every thread

    const int k0 = j * kKeys;
    float s[32], dp[32];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::wgmma_ss(s, tc::desc_k<kRows>(sQ, 0, kk), tc::desc_k<kKeys>(sK, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::wgmma_ss(dp, tc::desc_k<kRows>(sdO, 0, kk), tc::desc_k<kKeys>(sV, 0, kk), kk);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    // the reference's formula: a masked score is -2e30 before exp
    const bool edge = k0 + kKeys > key_end || (causal && k0 + kKeys - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      float t = s[i] * sc2;
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
        if (key >= key_end || (causal && key > row0 + 8 * hh)) t = kNegInf * tc::kLog2e;
      }
      s[i] = tc::exp2_approx(t - lse2[hh]) * (dp[i] - dl[hh]) * scale;  // dS
    }
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::a_fragment(s, kk, a[kk]);
    tc::wgmma_fence();
#pragma unroll
    for (int blk = 0; blk < kBlk; ++blk)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_rs_mn(acc[blk], a[kk], tc::desc_mn<kKeys>(sK, blk, kk));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int blk = 0; blk < kBlk; ++blk) tc::fence_regs(acc[blk]);
    __syncthreads();  // every thread is done with stage j & 1
  }

  // dQ in bf16 through the Q tile, 16-byte stores
  const float one[2] = {1.f, 1.f};
  tc::stage_rows<kRows, kBlk>(smem, 0, acc, one, warp, lane);
  __syncthreads();
  const auto out_row = [&](int t) {
    return (static_cast<size_t>(b) * Tq + t) * H * D + static_cast<size_t>(h) * D;
  };
  tc::store_tile<kRows, D, kThreads>(smem, dq, out_row, q0, Tq, tid);
}

template <int D>
cudaError_t launch_dq_wgmma(cudaStream_t s, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            int B, int Tq, int Tk, int H, int KVH, long long q_sb,
                            long long q_st, long long q_sh, long long kv_sb, long long kv_st,
                            long long kv_sh, int causal, float scale) {
  const size_t smem = rtt::tc::smem_bytes(DqLayout<D>::kSmem);
  cudaError_t err = rtt::allow_smem(flash_bwd_dq_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + DqLayout<D>::kRows - 1) / DqLayout<D>::kRows, H, B);
  flash_bwd_dq_wgmma_kernel<D><<<grid, 128, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Tq, Tk, H, KVH, q_sb, q_st,
      q_sh, kv_sb, kv_st, kv_sh, causal, scale);
  return cudaSuccess;
}

// ----------------------------------------- K4 on the tensor cores (bf16, D 64/128)

template <int D>
struct DkvLayout {
  static constexpr int kRows = 64;                // q rows per stage
  static constexpr uint32_t kKV = kKeys * D * 2;  // the K or the V tile
  static constexpr uint32_t kQ = kRows * D * 2;   // a stage's Q or dO tile
  // Q, dO, then lse and delta (64 f32 each), padded to keep 1024-B tiles
  static constexpr uint32_t kStage = 2 * kQ + 1024;
  static constexpr size_t kSmem = 2 * kKV + 2 * kStage;  // K, V, a ring of two stages
};

template <int D>
__global__ void __launch_bounds__(128, 2)
    flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
                               int H, int KVH, long long q_sb, long long q_st, long long q_sh,
                               long long kv_sb, long long kv_st, long long kv_sh, int causal,
                               float scale) {
  namespace tc = rtt::tc;
  using L = DkvLayout<D>;
  constexpr int kRows = L::kRows, kThreads = 128, kBlk = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = tc::aligned_smem(smem_raw);
  const uint32_t sK = tc::smem_u32(smem), sV = sK + L::kKV, sRing = sV + L::kKV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // grid (KVH, B, key tiles): key tile 0, which sees the most q tiles,
  // for every (kv head, sequence) first
  const int kvh = blockIdx.x, b = blockIdx.y, g = H / KVH;
  const int k0 = blockIdx.z * kKeys;  // the CTA's keys [k0, k0 + 64)
  const Rows kvrows{kv_sb, kv_st, kv_sh, b, kvh};

  // under causal masking, rows before k0 see none of the tile's keys; the
  // (q head of the group, q tile) pairs stream through a two-stage ring
  const int qt_first = causal ? k0 / kRows : 0;
  const int n_qt = max(0, (Tq + kRows - 1) / kRows - qt_first);
  const int n_it = g * n_qt;
  const auto load_stage = [&](int it) {
    const int hq = kvh * g + it / n_qt, q0 = (qt_first + it % n_qt) * kRows;
    const uint32_t st = sRing + (it & 1) * L::kStage;
    const Rows qrows{q_sb, q_st, q_sh, b, hq};
    tc::load_tile<kRows, D, kThreads>(st, q, qrows, q0, Tq, tid);
    tc::load_tile<kRows, D, kThreads>(st + L::kQ, dout, qrows, q0, Tq, tid);
    if (tid < 2 * kRows) {  // lse then delta of the tile's rows; rows past Tq read 0
      const int t = q0 + (tid & (kRows - 1));
      const float* src = tid < kRows ? lse : delta;
      const bool valid = t < Tq;
      tc::cp_async4(st + 2 * L::kQ + 4 * tid,
                    valid ? src + (static_cast<size_t>(b) * H + hq) * Tq + t : src, valid);
    }
  };
  // copy groups: {K, V, stage 0}, then per iteration {stage it + 1}
  tc::load_tile<kKeys, D, kThreads>(sK, k, kvrows, k0, Tk, tid);
  tc::load_tile<kKeys, D, kThreads>(sV, v, kvrows, k0, Tk, tid);
  if (n_it > 0) load_stage(0);
  tc::cp_async_commit();

  float dk_acc[kBlk][32], dv_acc[kBlk][32];
#pragma unroll
  for (int blk = 0; blk < kBlk; ++blk)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[blk][i] = dv_acc[blk][i] = 0.f;
  const float sc2 = scale * tc::kLog2e;
  // accumulator value i: key key_lo + 8 ((i / 2) % 2), q row
  // q0 + 8 (i / 4) + col0 + i % 2 (wgmma.cuh): the keys are M, the rows N
  const int key_lo = k0 + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);

  for (int it = 0; it < n_it; ++it) {
    const uint32_t st = sRing + (it & 1) * L::kStage;
    if (it + 1 < n_it) {
      load_stage(it + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_async_proxy();
    __syncthreads();  // stage it (and K, V) in shared memory for every thread

    const int q0 = (qt_first + it % n_qt) * kRows;
    const uint32_t sQ = st, sdO = st + L::kQ;
    const float* lse_s = reinterpret_cast<const float*>(smem + (st - sK) + 2 * L::kQ);
    const float* dl_s = lse_s + kRows;
    float s[32], dp[32];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::wgmma_ss(s, tc::desc_k<kKeys>(sK, 0, kk), tc::desc_k<kRows>(sQ, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::wgmma_ss(dp, tc::desc_k<kKeys>(sV, 0, kk), tc::desc_k<kRows>(sdO, 0, kk), kk);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    // P^T = exp2(S^T scale log2(e) - lse log2(e)), the reference's formula
    // (a masked score is -2e30 before exp); lse indexes the columns
    const bool edge = k0 + kKeys > Tk || q0 + kRows > Tq || (causal && k0 + kKeys - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + col0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          const float lg = (e ? ls.y : ls.x) * tc::kLog2e;
          float t = s[i] * sc2;
          if (edge) {
            const int key = key_lo + 8 * hh, row = q0 + 8 * j + col0 + e;
            if (key >= Tk || (causal && key > row)) t = kNegInf * tc::kLog2e;
            s[i] = row < Tq ? tc::exp2_approx(t - lg) : 0.f;
          } else {
            s[i] = tc::exp2_approx(t - lg);
          }
        }
    }
    // dS^T = P^T (dP^T - delta) scale; then dV += P^T dO and dK += dS^T Q
    // in one group, reading dO and Q MN-major from the bytes S^T and dP^T
    // read K-major (issuing dV before forming dS^T ran no faster and left
    // ptxas 8 bytes of spills; PERF.md)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + 8 * j + col0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          dp[i] = s[i] * (dp[i] - (e ? dl.y : dl.x)) * scale;
        }
    }
    uint32_t ap[4][4], as[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tc::a_fragment(s, kk, ap[kk]);
      tc::a_fragment(dp, kk, as[kk]);
    }
    tc::wgmma_fence();
#pragma unroll
    for (int blk = 0; blk < kBlk; ++blk)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_rs_mn(dv_acc[blk], ap[kk], tc::desc_mn<kRows>(sdO, blk, kk));
#pragma unroll
    for (int blk = 0; blk < kBlk; ++blk)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_rs_mn(dk_acc[blk], as[kk], tc::desc_mn<kRows>(sQ, blk, kk));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int blk = 0; blk < kBlk; ++blk) {
      tc::fence_regs(dv_acc[blk]);
      tc::fence_regs(dk_acc[blk]);
    }
    __syncthreads();  // every thread is done with stage it & 1
  }

  // dK and dV in bf16 through the K and V tiles, 16-byte stores (no copy
  // is in flight and no product reads the tiles any more)
  tc::cp_async_wait<0>();
  __syncthreads();
  const float one[2] = {1.f, 1.f};
  tc::stage_rows<kKeys, kBlk>(smem, 0, dk_acc, one, warp, lane);
  tc::stage_rows<kKeys, kBlk>(smem + L::kKV, 0, dv_acc, one, warp, lane);
  __syncthreads();
  const auto out_row = [&](int t) {
    return (static_cast<size_t>(b) * Tk + t) * KVH * D + static_cast<size_t>(kvh) * D;
  };
  tc::store_tile<kKeys, D, kThreads>(smem, dk, out_row, k0, Tk, tid);
  tc::store_tile<kKeys, D, kThreads>(smem + L::kKV, dv, out_row, k0, Tk, tid);
}

template <int D>
cudaError_t launch_dkv_wgmma(cudaStream_t s, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta, void* dk,
                             void* dv, int B, int Tq, int Tk, int H, int KVH, long long q_sb,
                             long long q_st, long long q_sh, long long kv_sb, long long kv_st,
                             long long kv_sh, int causal, float scale) {
  const size_t smem = rtt::tc::smem_bytes(DkvLayout<D>::kSmem);
  cudaError_t err = rtt::allow_smem(flash_bwd_dkv_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KVH, B, (Tk + kKeys - 1) / kKeys);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, 128, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk,
      H, KVH, q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, causal, scale);
  return cudaSuccess;
}

bool bwd_args_ok(int B, int Tq, int Tk, int H, int KVH, int D) {
  return B > 0 && Tq > 0 && Tk > 0 && KVH > 0 && H % KVH == 0 && D > 0 && D <= kMaxD;
}

}  // namespace

extern "C" int rtt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int B, int Tq, int Tk, int H, int KVH, int D,
                                          long long q_sb, long long q_st, long long q_sh,
                                          long long kv_sb, long long kv_st, long long kv_sh,
                                          int causal, float scale, int dtype, void* stream) {
  if (!bwd_args_ok(B, Tq, Tk, H, KVH, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16 && (D == 64 || D == 128)) {  // the tensor-core tile
    if (!rtt::kv_layout_ok<bf16>(k, v, D, kv_sb, kv_st, kv_sh) ||
        !rtt::kv_layout_ok<bf16>(q, dout, D, q_sb, q_st, q_sh))
      return cudaErrorInvalidValue;
    cudaError_t err =
        D == 64 ? launch_dq_wgmma<64>(s, q, k, v, dout, lse, delta, dq, B, Tq, Tk, H, KVH,
                                        q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, causal, scale)
                : launch_dq_wgmma<128>(s, q, k, v, dout, lse, delta, dq, B, Tq, Tk, H, KVH,
                                         q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, causal, scale);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  const size_t smem = dq_smem_bytes(D);
  const dim3 grid((Tq + kR - 1) / kR, H, B);
  RTT_DISPATCH_DTYPE(dtype, T, {
    if (!rtt::kv_layout_ok<T>(k, v, D, kv_sb, kv_st, kv_sh) ||
        !rtt::kv_layout_ok<T>(q, dout, D, q_sb, q_st, q_sh))
      return cudaErrorInvalidValue;
    cudaError_t err = rtt::allow_smem(flash_bwd_dq_fma_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_fma_kernel<T><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), Tq, Tk, H, KVH, D, q_sb, q_st,
        q_sh, kv_sb, kv_st, kv_sh, causal, scale);
  });
  return cudaGetLastError();
}

extern "C" int rtt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int B, int Tq, int Tk, int H,
                                           int KVH, int D, long long q_sb, long long q_st,
                                           long long q_sh, long long kv_sb, long long kv_st,
                                           long long kv_sh, int causal, float scale, int dtype,
                                           void* stream) {
  if (!bwd_args_ok(B, Tq, Tk, H, KVH, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kBF16 && (D == 64 || D == 128)) {  // the tensor-core tile
    if (!rtt::kv_layout_ok<bf16>(k, v, D, kv_sb, kv_st, kv_sh) ||
        !rtt::kv_layout_ok<bf16>(q, dout, D, q_sb, q_st, q_sh) || B > 65535 ||
        (Tk + 63) / 64 > 65535)
      return cudaErrorInvalidValue;
    cudaError_t err =
        D == 64 ? launch_dkv_wgmma<64>(s, q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, H, KVH,
                                         q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, causal, scale)
                : launch_dkv_wgmma<128>(s, q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, H, KVH,
                                          q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, causal, scale);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  const size_t smem = dkv_smem_bytes(D);
  const dim3 grid((Tk + kK - 1) / kK, KVH, B);
  RTT_DISPATCH_DTYPE(dtype, T, {
    if (!rtt::kv_layout_ok<T>(k, v, D, kv_sb, kv_st, kv_sh) ||
        !rtt::kv_layout_ok<T>(q, dout, D, q_sb, q_st, q_sh))
      return cudaErrorInvalidValue;
    cudaError_t err = rtt::allow_smem(flash_bwd_dkv_fma_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_fma_kernel<T><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, H,
        KVH, D, q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, causal, scale);
  });
  return cudaGetLastError();
}
