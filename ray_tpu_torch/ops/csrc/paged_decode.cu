// Paged-decode attention for NVIDIA Hopper (sm_90a): one query token per
// slot attends to that slot's keys in the paged KV pool, read in place
// through its page table.
//
// Replaces no TPU kernel. The JAX engine's decode attention is plain jnp
// under jax.jit (ray_tpu/llm/engine.py:220-230), which XLA fuses; in eager
// PyTorch the same lines gather every slot's whole page table, repeat it
// to every query head and materialise both copies. This kernel computes
// the same function without the copies: for slot b, query head h of kv
// head h / G, o[b, h] = softmax(scale * q[b, h] . K[b, :n]) . V[b, :n] with
// the valid keys 0 .. lengths[b] inclusive (n = lengths[b] + 1, at most
// T = P * page), an f32 online softmax and f32 accumulation, o rounded to
// the input type. Inactive slots read nothing and write zero rows.
//
// Layout: q (B, Hq, D) with batch and head strides (D contiguous); one
// layer of the pool, k and v (N, page, KV, D) contiguous; tables (B, P)
// int64 physical page ids (row stride given, columns contiguous);
// lengths (B,) int64; active (B,) bool; o (B, Hq, D) contiguous.
//
// What bounds it on an H100 SXM: bytes. A decode step reads each live
// key and value row once, (n) x KV x D x 2 tensors x 2 B per slot, plus q
// and o, against 3.35 TB/s; its operations, 4 x Hq x D a key, are a
// fraction of an operation per byte, far below the card's ~295.
//
// Design, for bytes:
//  - Grid (split, kv head x head chunk, slot). A block reads one kv head's
//    keys of one split of the slot's range, and serves all G = Hq / KV
//    query heads of that kv head from one read (up to 16 heads a block:
//    G > 16 takes ceil(G / 16) head chunks). The split length follows the
//    shapes (B, KV, T) alone, so the grid never waits on a device value;
//    blocks whose split starts past the slot's length, and blocks of
//    inactive slots, exit at once. With more than one split, a second
//    small kernel merges the splits by their log-sum-exp.
//  - bf16: each of 4 warps takes steps of 16 keys in turn. A step's K and
//    V rows (16 x 256 B each at D = 128) come with 16-byte cp.async loads,
//    coalesced over D, into a 3-stage ring in shared memory, so two steps
//    are in flight under the one being computed. Every lane reads back
//    only the 16-byte chunks it loaded itself, so the ring needs no barrier:
//    cp.async.wait_group orders each lane's own copies. A page row of one
//    kv head is read where the table points, 2 KB apart per position at
//    KV 8, D 128; keys past the slot's end are zero-filled, never read.
//  - The products run on the tensor cores with mma.sync m16n8k16 (bf16
//    in, f32 out): the query heads are the 16 rows of A (rows past G are
//    zero), eight keys the columns of Q.K^T. The head dim is permuted
//    consistently between Q and K (a dot product does not depend on the
//    order of its terms), so each lane's K fragments are whole 16-byte
//    chunks of one row; P, packed to bf16 in registers, is the A operand
//    of P.V, whose B fragments pair two keys' values with one byte_perm,
//    and o's columns are un-permuted on the way out.
//  - Online softmax in base 2 (scores scaled by scale x log2 e), per warp;
//    the four warps' states are merged in shared memory at the end.
//  - f32: CUDA-core FMAs in f32 throughout (tensor cores would round the
//    inputs), one block per query head, one warp per key in turn.

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStepKeys = 16;  // keys a warp takes per step
constexpr int kStages = 3;     // cp.async ring depth per warp
constexpr int kHeads = 16;     // query heads a block serves (mma rows)
constexpr float kNegInf = -__builtin_huge_valf();

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// d (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col). With
// g = lane / 4, t = lane % 4: a0 = (row g, k 2t..2t+1), a1 = (row g + 8,
// k 2t..), a2 = (row g, k 2t+8..), a3 = (row g + 8, k 2t+8..); b0 = (k
// 2t..2t+1, col g), b1 = (k 2t+8.., col g); d0, d1 = (row g, cols 2t,
// 2t+1), d2, d3 = (row g + 8, cols 2t, 2t+1).
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Pool row (element offset of position `key`'s kv head 0) through the
// slot's page table. Any page size: the division costs a few instructions
// a row, and the kernel waits on memory, not on issue.
__device__ __forceinline__ long long pool_row(const long long* trow, int key,
                                              int page, long long row_elems) {
  const int pi = key / page;
  const long long pg = __ldg(trow + pi);
  return (pg * page + (key - pi * page)) * row_elems;
}

// ---------------------------------------------------------------- bf16 --

// Per lane and step: K of two 8-key blocks, kCPL 16-byte chunks of one row
// each (chunks t, t + 4, ... of the row), then V of four keys (2t, 2t + 1
// of each block), kVC chunks each (chunks g, g + 8). Shared memory of a
// warp's stage is [chunk][lane] x 16 B, so a warp's ld.shared.v4 of one
// chunk reads 512 contiguous bytes.
template <int D>
struct Bf16Cfg {
  static constexpr int kCPL = D / 32;
  static constexpr int kVC = D / 64;
  static constexpr int kChunks = 2 * kCPL + 4 * kVC;
  static constexpr int kNBlocks = D / 8;  // 8-column blocks of o
  static constexpr int kStageBytes = kChunks * 32 * 16;
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kSmem = kWarps * kWarpBytes;
  // The end-of-block merge reuses a warp's ring: acc [16][D], m [16], l [16].
  static_assert(kHeads * D * 4 + 2 * kHeads * 4 <= kWarpBytes, "merge area");
};

template <int D, bool HI>
__global__ void __launch_bounds__(kThreads, 2)
pd_bf16(const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ pk,
        const __nv_bfloat16* __restrict__ pv,
        const long long* __restrict__ tables,
        const long long* __restrict__ lengths,
        const bool* __restrict__ active, __nv_bfloat16* __restrict__ o,
        float* __restrict__ part_o, float* __restrict__ part_lse, int Hq,
        int G, int KV, int page, int P, long long sq_b, long long sq_h,
        long long st_b, int chunk, int S, float scale_log2) {
  using C = Bf16Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, b = blockIdx.z;
  const int n_chunks = (G + kHeads - 1) / kHeads;
  const int kvh = blockIdx.y / n_chunks;
  const int h0 = (blockIdx.y % n_chunks) * kHeads;
  const int Gc = min(kHeads, G - h0);
  const int head0 = kvh * G + h0;  // the chunk's first query head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  if (!active[b]) {
    if (S == 1)
      for (int i = tid; i < Gc * D; i += kThreads)
        o[(static_cast<long long>(b) * Hq + head0) * D + i] =
            __float2bfloat16(0.f);
    return;
  }
  const int T = P * page;
  const int n = static_cast<int>(min(lengths[b] + 1, static_cast<long long>(T)));
  const int start = split * chunk;
  if (start >= n) return;
  const int end = min(start + chunk, n);

  // Q as the A operand: head rows g (and g + 8), the lane's chunks
  // t, t + 4, ... of each row, matching K's permuted head dim.
  uint32_t qlo[C::kCPL][4], qhi[C::kCPL][4];
  const __nv_bfloat16* qb = q + b * sq_b;
#pragma unroll
  for (int c = 0; c < C::kCPL; ++c) {
    uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
    if (h0 + g < G)
      lo = *reinterpret_cast<const uint4*>(qb + (head0 + g) * sq_h +
                                           8 * (4 * c + t));
    if (HI && h0 + g + 8 < G)
      hi = *reinterpret_cast<const uint4*>(qb + (head0 + g + 8) * sq_h +
                                           8 * (4 * c + t));
    qlo[c][0] = lo.x, qlo[c][1] = lo.y, qlo[c][2] = lo.z, qlo[c][3] = lo.w;
    qhi[c][0] = hi.x, qhi[c][1] = hi.y, qhi[c][2] = hi.z, qhi[c][3] = hi.w;
  }

  const int n_steps = (end - start + kStepKeys - 1) / kStepKeys;
  const int my_n = n_steps > warp ? (n_steps - warp + kWarps - 1) / kWarps : 0;
  const uint32_t wbase = smem_addr(smem) + warp * C::kWarpBytes;
  const long long* trow = tables + b * st_b;
  const long long row_elems = static_cast<long long>(KV) * D;
  const __nv_bfloat16* pk_h = pk + kvh * D;
  const __nv_bfloat16* pv_h = pv + kvh * D;

  auto issue = [&](int i) {
    const int kb = start + (warp + kWarps * i) * kStepKeys;
    const uint32_t sb = wbase + (i % kStages) * C::kStageBytes;
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      const int key = kb + 8 * blk + g;
      const bool ok = key < end;
      const __nv_bfloat16* src =
          ok ? pk_h + pool_row(trow, key, page, row_elems) : pk;
#pragma unroll
      for (int c = 0; c < C::kCPL; ++c)
        cp_async16(sb + ((blk * C::kCPL + c) * 32 + lane) * 16,
                   src + 8 * (4 * c + t), ok);
    }
#pragma unroll
    for (int vk = 0; vk < 4; ++vk) {
      const int key = kb + (vk >> 1) * 8 + 2 * t + (vk & 1);
      const bool ok = key < end;
      const __nv_bfloat16* src =
          ok ? pv_h + pool_row(trow, key, page, row_elems) : pv;
#pragma unroll
      for (int h = 0; h < C::kVC; ++h)
        cp_async16(sb + ((2 * C::kCPL + vk * C::kVC + h) * 32 + lane) * 16,
                   src + 8 * (g + 8 * h), ok);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < my_n) issue(i);
    cp_async_commit();
  }

  float m_lo = kMaskFill, m_hi = kMaskFill, l_lo = 0.f, l_hi = 0.f;
  float acc[C::kNBlocks][4];
#pragma unroll
  for (int j = 0; j < C::kNBlocks; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < my_n; ++i) {
    if (i + kStages - 1 < my_n) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    const uint32_t sb = wbase + (i % kStages) * C::kStageBytes;
    const int kb = start + (warp + kWarps * i) * kStepKeys;

    // S = Q.K^T for two blocks of 8 keys: s[blk][0..1] head g, keys
    // kb + 8 blk + 2t, + 1; s[blk][2..3] head g + 8.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
#pragma unroll
      for (int c = 0; c < C::kCPL; ++c) {
        const uint4 kr = lds128(sb + ((blk * C::kCPL + c) * 32 + lane) * 16);
        mma16816(s[blk], qlo[c][0], HI ? qhi[c][0] : 0u, qlo[c][1],
                 HI ? qhi[c][1] : 0u, kr.x, kr.y);
        mma16816(s[blk], qlo[c][2], HI ? qhi[c][2] : 0u, qlo[c][3],
                 HI ? qhi[c][3] : 0u, kr.z, kr.w);
      }
    }
#pragma unroll
    for (int blk = 0; blk < 2; ++blk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[blk][e] = kb + 8 * blk + 2 * t + (e & 1) < end
                        ? s[blk][e] * scale_log2
                        : kNegInf;

    float mx_lo = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float a_lo = exp2f(m_lo - mn_lo);
    m_lo = mn_lo;
    float p[2][4];
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      p[blk][0] = exp2f(s[blk][0] - mn_lo);
      p[blk][1] = exp2f(s[blk][1] - mn_lo);
    }
    l_lo = l_lo * a_lo + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
    float a_hi = 1.f;
    if (HI) {
      float mx_hi = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float mn_hi = fmaxf(m_hi, mx_hi);
      a_hi = exp2f(m_hi - mn_hi);
      m_hi = mn_hi;
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {
        p[blk][2] = exp2f(s[blk][2] - mn_hi);
        p[blk][3] = exp2f(s[blk][3] - mn_hi);
      }
      l_hi = l_hi * a_hi + (p[0][2] + p[0][3]) + (p[1][2] + p[1][3]);
    }
#pragma unroll
    for (int j = 0; j < C::kNBlocks; ++j) {
      acc[j][0] *= a_lo;
      acc[j][1] *= a_lo;
      if (HI) {
        acc[j][2] *= a_hi;
        acc[j][3] *= a_hi;
      }
    }
    // P as the A operand of P.V: keys 2t, 2t + 1 of block 0 are k 2t..,
    // those of block 1 are k 2t + 8...
    const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]);
    const uint32_t pa2 = pack_bf16(p[1][0], p[1][1]);
    const uint32_t pa1 = HI ? pack_bf16(p[0][2], p[0][3]) : 0u;
    const uint32_t pa3 = HI ? pack_bf16(p[1][2], p[1][3]) : 0u;

    uint4 vr[4][C::kVC];
#pragma unroll
    for (int vk = 0; vk < 4; ++vk)
#pragma unroll
      for (int h = 0; h < C::kVC; ++h)
        vr[vk][h] =
            lds128(sb + ((2 * C::kCPL + vk * C::kVC + h) * 32 + lane) * 16);
    // Column g of o block j is head dim 64 (j / 8) + 8 g + j % 8: element
    // j % 8 of the lane's chunk g + 8 (j / 8) of each of its four keys.
#pragma unroll
    for (int j = 0; j < C::kNBlocks; ++j) {
      const int h = j >> 3, w = (j & 7) >> 1;
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
      const uint32_t b0 =
          __byte_perm(word(vr[0][h], w), word(vr[1][h], w), sel);
      const uint32_t b1 =
          __byte_perm(word(vr[2][h], w), word(vr[3][h], w), sel);
      mma16816(acc[j], pa0, pa1, pa2, pa3, b0, b1);
    }
  }
  cp_async_wait<0>();

  // Merge the four warps: each writes its state into its own ring.
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  if (HI) {
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  }
  float* red = reinterpret_cast<float*>(smem + warp * C::kWarpBytes);
#pragma unroll
  for (int j = 0; j < C::kNBlocks; ++j) {
    const int d0 = 64 * (j >> 3) + 16 * t + (j & 7);
    red[g * D + d0] = acc[j][0];
    red[g * D + d0 + 8] = acc[j][1];
    if (HI) {
      red[(g + 8) * D + d0] = acc[j][2];
      red[(g + 8) * D + d0 + 8] = acc[j][3];
    }
  }
  if (t == 0) {
    red[kHeads * D + g] = m_lo;
    red[kHeads * D + kHeads + g] = l_lo;
    if (HI) {
      red[kHeads * D + g + 8] = m_hi;
      red[kHeads * D + kHeads + g + 8] = l_hi;
    }
  }
  __syncthreads();
  for (int i = tid; i < Gc * D; i += kThreads) {
    const int hh = i / D, d = i % D;
    float mw[kWarps], M = kMaskFill;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = reinterpret_cast<const float*>(
          smem + w * C::kWarpBytes)[kHeads * D + hh];
      M = fmaxf(M, mw[w]);
    }
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* rw = reinterpret_cast<const float*>(smem + w * C::kWarpBytes);
      const float f = exp2f(mw[w] - M);
      L += rw[kHeads * D + kHeads + hh] * f;
      O += rw[hh * D + d] * f;
    }
    const long long row = static_cast<long long>(b) * Hq + head0 + hh;
    const float out = O * __frcp_rn(L);
    if (S == 1) {
      o[row * D + d] = __float2bfloat16(out);
    } else {
      part_o[(row * S + split) * D + d] = out;
      if (d == 0) part_lse[row * S + split] = M + log2f(L);
    }
  }
}

// ----------------------------------------------------------------- f32 --

// One block per (split, query head, slot); warp w takes keys start + w,
// start + w + 4, ...; lane owns D / 32 head dims.
template <int D>
__global__ void __launch_bounds__(kThreads)
pd_f32(const float* __restrict__ q, const float* __restrict__ pk,
       const float* __restrict__ pv, const long long* __restrict__ tables,
       const long long* __restrict__ lengths, const bool* __restrict__ active,
       float* __restrict__ o, float* __restrict__ part_o,
       float* __restrict__ part_lse, int Hq, int G, int KV, int page,
       int P, long long sq_b, long long sq_h, long long st_b, int chunk,
       int S, float scale_log2) {
  constexpr int E = D / 32;
  __shared__ float sm_acc[kWarps][D];
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = static_cast<long long>(b) * Hq + h;
  if (!active[b]) {
    if (S == 1)
      for (int d = tid; d < D; d += kThreads) o[row * D + d] = 0.f;
    return;
  }
  const int T = P * page;
  const int n = static_cast<int>(min(lengths[b] + 1, static_cast<long long>(T)));
  const int start = split * chunk;
  if (start >= n) return;
  const int end = min(start + chunk, n);
  const long long* trow = tables + b * st_b;
  const long long row_elems = static_cast<long long>(KV) * D;

  const float* kh = pk + kvh * D + lane * E;
  const float* vh = pv + kvh * D + lane * E;
  float qr[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qr[e] = q[b * sq_b + h * sq_h + lane * E + e];
    acc[e] = 0.f;
  }
  float m = kMaskFill, l = 0.f;
#pragma unroll 1
  for (int key = start + warp; key < end; key += kWarps) {
    const long long r = pool_row(trow, key, page, row_elems);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dot = fmaf(qr[e], kh[r + e], dot);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float x = dot * scale_log2;
    const float mn = fmaxf(m, x);
    const float a = exp2f(m - mn), p = exp2f(x - mn);
    l = l * a + p;
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] = fmaf(p, vh[r + e], acc[e] * a);
    m = mn;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
  if (lane == 0) sm_m[warp] = m, sm_l[warp] = l;
  __syncthreads();
  float M = kMaskFill;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) L += sm_l[w] * exp2f(sm_m[w] - M);
  const float inv = __frcp_rn(L);
  for (int d = tid; d < D; d += kThreads) {
    float O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) O += sm_acc[w][d] * exp2f(sm_m[w] - M);
    if (S == 1) {
      o[row * D + d] = O * inv;
    } else {
      part_o[(row * S + split) * D + d] = O * inv;
      if (d == 0) part_lse[row * S + split] = M + log2f(L);
    }
  }
}

// --------------------------------------------------------------- merge --

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One block per (slot, query head), a thread per head dim: o = the live
// splits' normalised outputs weighted by exp2(lse - max lse).
template <typename Out>
__global__ void pd_merge(const float* __restrict__ part_o,
                         const float* __restrict__ part_lse,
                         const long long* __restrict__ lengths,
                         const bool* __restrict__ active, Out* __restrict__ o,
                         int Hq, int D, int T, int chunk, int S) {
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / Hq);
  const int d = threadIdx.x;
  if (!active[b]) {
    store(o + row * D + d, 0.f);
    return;
  }
  const int n = static_cast<int>(min(lengths[b] + 1, static_cast<long long>(T)));
  const int live = (n + chunk - 1) / chunk;
  const float* lse = part_lse + row * S;
  float M = kMaskFill;
  for (int s = 0; s < live; ++s) M = fmaxf(M, lse[s]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < live; ++s) {
    const float f = exp2f(lse[s] - M);
    L += f;
    O += f * part_o[(row * S + s) * D + d];
  }
  store(o + row * D + d, O * __frcp_rn(L));
}

template <int D, bool HI>
cudaError_t launch_bf16(cudaStream_t st, dim3 grid, const void* q,
                        const void* pk, const void* pv, const long long* tb,
                        const long long* len, const bool* act, void* o,
                        float* part_o, float* part_lse, int Hq, int G, int KV,
                        int page, int P, long long sq_b, long long sq_h,
                        long long st_b, int chunk, int S, float scale_log2) {
  constexpr int smem = Bf16Cfg<D>::kSmem;
  // Above 48 KB needs the opt-in, which holds for the current device
  // only, so it is set on every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      pd_bf16<D, HI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pd_bf16<D, HI><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pk),
      static_cast<const __nv_bfloat16*>(pv), tb, len, act,
      static_cast<__nv_bfloat16*>(o), part_o, part_lse, Hq, G, KV,
      page, P, sq_b, sq_h, st_b, chunk, S, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, cudaStream_t st, const void* q, const void* pk,
                   const void* pv, const long long* tb, const long long* len,
                   const bool* act, void* o, float* part_o, float* part_lse,
                   int B, int Hq, int KV, int page, int P,
                   long long sq_b, long long sq_h, long long st_b, int chunk,
                   int S, float scale_log2) {
  const int G = Hq / KV;
  cudaError_t err;
  if (dtype == 1) {
    const dim3 grid(S, KV * ((G + kHeads - 1) / kHeads), B);
    err = G > 8 ? launch_bf16<D, true>(st, grid, q, pk, pv, tb, len, act, o,
                                       part_o, part_lse, Hq, G, KV,
                                       page, P, sq_b, sq_h, st_b,
                                       chunk, S, scale_log2)
                : launch_bf16<D, false>(st, grid, q, pk, pv, tb, len, act, o,
                                        part_o, part_lse, Hq, G, KV,
                                        page, P, sq_b, sq_h, st_b,
                                        chunk, S, scale_log2);
  } else {
    pd_f32<D><<<dim3(S, Hq, B), kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(pk),
        static_cast<const float*>(pv), tb, len, act, static_cast<float*>(o),
        part_o, part_lse, Hq, G, KV, page, P, sq_b, sq_h, st_b, chunk,
        S, scale_log2);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || S == 1) return err;
  const int T = P * page;
  if (dtype == 1)
    pd_merge<__nv_bfloat16><<<B * Hq, D, 0, st>>>(
        part_o, part_lse, len, act, static_cast<__nv_bfloat16*>(o), Hq, D, T,
        chunk, S);
  else
    pd_merge<float><<<B * Hq, D, 0, st>>>(part_o, part_lse, len, act,
                                          static_cast<float*>(o), Hq, D, T,
                                          chunk, S);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q strides in elements; tables' row
// stride in elements. chunk: keys per split (a multiple of 16), S splits
// covering T = P * page; part_o (B, Hq, S, D) and part_lse (B, Hq, S) f32
// scratch, unused when S == 1. scale multiplies q . k. Returns the
// cudaError_t of the launches (0 on success); runs on `stream`, no sync.
extern "C" int paged_decode(const void* q, const void* pk, const void* pv,
                            const void* tables, const void* lengths,
                            const void* active, void* o, void* part_o,
                            void* part_lse, int dtype, int B, int Hq, int KV,
                            int D, int page, int P, long long sq_b,
                            long long sq_h, long long st_b, int chunk, int S,
                            float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || KV <= 0 || Hq % KV != 0 || P <= 0 || page <= 0 ||
      chunk <= 0 || chunk % kStepKeys != 0 || S <= 0 ||
      static_cast<long long>(chunk) * S < static_cast<long long>(P) * page ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* tb = static_cast<const long long*>(tables);
  const auto* len = static_cast<const long long*>(lengths);
  const auto* act = static_cast<const bool*>(active);
  auto* po = static_cast<float*>(part_o);
  auto* pl = static_cast<float*>(part_lse);
  const float scale_log2 = scale * kLog2e;
  if (D == 64)
    return static_cast<int>(launch<64>(dtype, st, q, pk, pv, tb, len, act, o,
                                       po, pl, B, Hq, KV, page, P, sq_b,
                                       sq_h, st_b, chunk, S, scale_log2));
  if (D == 128)
    return static_cast<int>(launch<128>(dtype, st, q, pk, pv, tb, len, act,
                                        o, po, pl, B, Hq, KV, page, P,
                                        sq_b, sq_h, st_b, chunk, S,
                                        scale_log2));
  return static_cast<int>(cudaErrorInvalidValue);
}
