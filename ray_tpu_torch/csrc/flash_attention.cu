// K2: causal flash-attention forward with GQA.
//
// Replaces ray_tpu/ops/attention.py `_fwd_kernel` (launched by
// `_flash_fwd_pallas`): o = softmax(q k^T * scale, causal) v per (b, head),
// kv head h // g, f32 online softmax, rows with no visible key give 0. With
// a non-null `lse` it also writes the reference's logsumexp residual
// lse [B, H, Tq] f32 (`return_lse=True`), which the backward kernels K3/K4
// (flash_attention_bwd.cu) read. The two cases are two instantiations of
// one kernel, so a launch without lse (serving) runs the same code as
// before lse existed.
//
// Unlike the Pallas kernel, which needs T % block == 0 and T >= 128 (the
// JAX package falls back to XLA otherwise), this one takes every T: the
// ragged last tile is masked. It reads q/k/v of layout [B, T, H, D] through
// their strides, so callers never transpose, and writes a contiguous o.
//
// Grid: (ceil(Tq / 64), H, B), one CTA per 64-row query tile of one head;
// under causal masking a tile stops at its last row, so the key tiles wholly
// above the diagonal are never loaded. The tile loop and what bounds it are
// described in attention_tile.cuh.

#include "attention_tile.cuh"

namespace {

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
    flash_fwd_kernel(const T* q, const T* k, const T* v, T* o, float* lse, int Tq, int Tk,
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
cudaError_t launch_fwd(dim3 grid, size_t smem, cudaStream_t s, const void* q, const void* k,
                       const void* v, void* o, float* lse, int Tq, int Tk, int H, int KVH, int D,
                       long long q_sb, long long q_st, long long q_sh, long long kv_sb,
                       long long kv_st, long long kv_sh, int causal, float scale) {
  cudaError_t err = rtt::allow_smem(flash_fwd_kernel<T, kLse>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, kLse><<<grid, rtt::kTileThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Tq, Tk, H, KVH, D, q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, causal,
      scale);
  return cudaSuccess;
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
  const size_t smem = rtt::tile_smem_bytes(D);
  const dim3 grid((Tq + rtt::kTileR - 1) / rtt::kTileR, H, B);
  RTT_DISPATCH_DTYPE(dtype, T, {
    if (!rtt::kv_layout_ok<T>(k, v, D, kv_sb, kv_st, kv_sh)) return cudaErrorInvalidValue;
    float* l = static_cast<float*>(lse);
    cudaError_t err =
        l ? launch_fwd<T, true>(grid, smem, s, q, k, v, o, l, Tq, Tk, H, KVH, D, q_sb, q_st,
                                q_sh, kv_sb, kv_st, kv_sh, causal, scale)
          : launch_fwd<T, false>(grid, smem, s, q, k, v, o, l, Tq, Tk, H, KVH, D, q_sb, q_st,
                                 q_sh, kv_sb, kv_st, kv_sh, causal, scale);
    if (err != cudaSuccess) return err;
  });
  return cudaGetLastError();
}
