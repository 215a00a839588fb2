// Hopper tensor-core tools for the attention kernels K2 (flash_attention.cu),
// K3/K4 (flash_attention_bwd.cu) and K6/K7 (paged_attention.cu): bf16 tiles
// in 128-byte-swizzled shared memory filled by 16-byte cp.async copies (K5
// uses the cp.async helpers alone), the wgmma matrix descriptors that name
// that swizzle, the warpgroup instruction
// wgmma.mma_async.m64n64k16.f32.bf16.bf16 with both operands in shared
// memory (SS) or A in registers (RS), and the forward attention step that
// K2, K6 and K7 share: S = Q K^T, the online softmax on the fragment, and
// O += P V. Everything here is inline PTX; no CUTLASS header is included.
//
// Tile layout. A bf16 tile of R rows x D columns (D a multiple of 64, R a
// multiple of 8) is stored as D/64 column blocks, each R rows of 128 bytes;
// the 16-byte chunk c of a row r sits at chunk position c ^ (r % 8) of its
// row. Each block starts on a 1024-byte boundary, so the XOR acts on
// address bits [4, 7) with bits [7, 10), which is what the wgmma
// descriptor's 128-byte swizzle mode (layout type 1) reads. One such tile
// serves as a K-major operand (its rows are M or N, a k-step is 32 bytes
// of a row) and as an MN-major one (its rows are K, a k-step is 16 rows).
//
// Descriptor (64 bits): start address >> 4 in [0, 14), leading byte offset
// >> 4 in [16, 30), stride byte offset >> 4 in [32, 46), base offset 0,
// layout type in [62, 64). K-major: the stride byte offset is the step
// between 8-row groups (1024 bytes), the leading one is unused (1, as
// CUTLASS sets it). MN-major operands are only issued 64 columns wide (one
// swizzle atom along N), so the leading offset, the step between atoms
// along N, is unused too; both fields hold the 8-row step of 1024 bytes,
// which is right under either reading of the two fields.
//
// Accumulator fragment of m64nNk16 (f32): value i of the thread with lane
// l in warp w of its warpgroup holds row 16 w + l / 4 + 8 ((i / 2) % 2) and
// column 8 (i / 4) + 2 (l % 4) + i % 2. The A fragment of a k16 step in
// registers has the same map over its 16 columns, two bf16 to a register,
// so accumulator values 8 kk .. 8 kk + 7 packed in pairs are the A
// operand of k-step kk without any data exchange between threads.
#pragma once

#include "common.cuh"

namespace rtt {
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0 .. D/8 - 1) of row r in a tile of R rows
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// one f32 (or 4 bytes) by cp.async; src-size 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// makes this thread's completed shared-memory writes visible to wgmma,
// which reads through the async proxy; a barrier must follow
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + R) of a bf16 source of D columns (row t at element
// offset rows.kv_offset(t) of base, for any RowsT that provides it, as
// KVStager takes) into the tile at shared address dst, in 16-byte cp.async
// copies spread over THREADS threads; rows at or past row_end are
// zero-filled, so no NaN from memory past the end can reach a product
// whose probability is 0.
template <int R, int D, int THREADS, typename RowsT>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* base,
                                          const RowsT& rows, int row0, int row_end, int tid) {
  constexpr int kChunks = D / 8;
  static_assert((R * kChunks) % THREADS == 0, "tile chunks must divide over the threads");
#pragma unroll
  for (int i = 0; i < R * kChunks / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / kChunks, c = idx - (idx / kChunks) * kChunks;
    const bool valid = row0 + r < row_end;
    const __nv_bfloat16* src = valid ? base + rows.kv_offset(row0 + r) + c * 8 : base;
    cp_async16(dst + swz<R>(r, c), src, valid);
  }
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}
// K-major operand: rows r0 .. r0 + 63 (M) or .. + N - 1 of a tile of R
// rows, k-step kk (columns 16 kk .. 16 kk + 15)
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return desc(tile + (kk >> 2) * (R * 128) + r0 * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major operand: columns 64 blk .. 64 blk + 63 (N) of a tile of R rows,
// k-step kk (rows 16 kk .. 16 kk + 15)
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int blk, int kk) {
  return desc(tile + blk * (R * 128) + kk * 2048, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins an accumulator's registers after a wait, so no read of them is
// moved above it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RTT_WGMMA_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define RTT_WGMMA_OUT32(d)                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (+)= A B, m64n64k16, A and B K-major in shared memory; accumulate = 0
// overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RTT_WGMMA_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, A in registers (4 x 2 bf16), B MN-major in shared
// memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RTT_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef RTT_WGMMA_D32
#undef RTT_WGMMA_OUT32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x, the lower address, is lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand of k-step kk from accumulator values 8 kk .. 8 kk + 7 (see the
// fragment note above)
__device__ __forceinline__ void a_fragment(const float (&s)[32], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// 2^x on the MUFU unit (relative error about 2^-22; -2e30 gives +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for one warpgroup: its 64 rows from row q_r0 of a Q tile of QR
// rows against a K tile of 64 keys, as D/16 SS wgmma, waited for
template <int QR, int D>
__device__ __forceinline__ void qk_scores(float (&s)[32], uint32_t sQ, int q_r0, uint32_t sK) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, desc_k<QR>(sQ, q_r0, kk), desc_k<64>(sK, 0, kk), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// One key tile of the online softmax on the score fragment s (log2 units,
// masked entries kNegInf) for the thread's rows 16 w + l / 4 + 8 hh: the
// row max over the quad updates the running max m, s becomes P in place
// (all 0 while a row has no visible key), this thread's share of the
// running sum l is rescaled and added to, and alpha[hh] is O's rescale
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = m[hh];
#pragma unroll
    for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(s[4 * c + 2 * hh], s[4 * c + 2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const bool live = mx > 0.5f * kNegInf;  // some key of the row is visible
    alpha[hh] = exp2_approx(m[hh] - mx);
    m[hh] = mx;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * c + 2 * hh + e;
        s[i] = live ? exp2_approx(s[i] - mx) : 0.f;
        sum += s[i];
      }
    l[hh] = l[hh] * alpha[hh] + sum;
  }
}

// O = alpha O + P V for one warpgroup: P from the score fragment, packed to
// bf16 as the register A operand, V a tile of 64 keys read MN-major; O is
// BLKS blocks of 64 columns; waited for
template <int BLKS>
__device__ __forceinline__ void pv_accumulate(float (&acc)[BLKS][32], const float (&p)[32],
                                              const float (&alpha)[2], uint32_t sV) {
#pragma unroll
  for (int blk = 0; blk < BLKS; ++blk)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[blk][i] *= alpha[(i >> 1) & 1];
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) a_fragment(p, kk, a[kk]);
  wgmma_fence();
#pragma unroll
  for (int blk = 0; blk < BLKS; ++blk)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(acc[blk], a[kk], desc_mn<64>(sV, blk, kk));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int blk = 0; blk < BLKS; ++blk) fence_regs(acc[blk]);
}

// a row's value summed over the four threads of its quad
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The warpgroup's 64 x (64 * BLKS) f32 accumulator, scaled per row, into
// its rows [r0, r0 + 64) of a bf16 tile of R rows at generic address tile,
// in the swizzled layout; `row_scale[h]` applies to the thread's rows
// 16 w + l / 4 + 8 h.
template <int R, int BLKS>
__device__ __forceinline__ void stage_rows(uint8_t* tile, int r0, const float (&acc)[BLKS][32],
                                           const float (&row_scale)[2], int warp, int lane) {
#pragma unroll
  for (int blk = 0; blk < BLKS; ++blk)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh;
        const int r = r0 + 16 * warp + (lane >> 2) + 8 * hh;
        *reinterpret_cast<uint32_t*>(tile + swz<R>(r, 8 * blk + j) + 4 * (lane & 3)) =
            pack_bf16(acc[blk][i] * row_scale[hh], acc[blk][i + 1] * row_scale[hh]);
      }
}

// Rows [0, R) of a staged bf16 tile to out + row_off(t) for t = t0 + r
// below t_end, in 16-byte stores
template <int R, int D, int THREADS, typename RowOff>
__device__ __forceinline__ void store_tile(const uint8_t* tile, __nv_bfloat16* out,
                                           const RowOff& row_off, int t0, int t_end, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < R * kChunks / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / kChunks, c = idx - (idx / kChunks) * kChunks;
    if (t0 + r < t_end)
      *reinterpret_cast<uint4*>(out + row_off(t0 + r) + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<R>(r, c));
  }
}

// Shared memory of an attention kernel: `tiles` bytes of 1024-aligned
// tiles, plus the slack to align the dynamic base
inline size_t smem_bytes(size_t tiles) { return tiles + 1024; }

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

}  // namespace tc
}  // namespace rtt
