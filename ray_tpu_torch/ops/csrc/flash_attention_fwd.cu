// Flash-attention forward for NVIDIA Hopper (sm_90a), with the row
// logsumexp.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py:_fa_fwd_kernel
// (body _fa_kernel), launched there by _flash_forward_pallas. It computes
// the same function: causal or non-causal GQA attention with an f32 online
// softmax (running max m, running denominator l, f32 accumulator), the
// causal mask filled with -1e30, key tiles wholly above the diagonal
// skipped, o = acc / max(l, 1e-30) in the input type and
// lse = m + log(max(l, 1e-30)) in f32.
//
// Layout: q (B, S, Hq, D), k/v (B, S, Hkv, D), o (B, S, Hq, D), read and
// written through their batch/sequence/head strides (the last dim is
// contiguous), so the caller transposes nothing. lse is (B, Hq, S) f32.
// Query head h reads kv head h / (Hq / Hkv).
//
// What bounds it on an H100 SXM: operations 4*B*Hq*D*P with P the live
// (query, key) pairs (S*S, or S*(S+1)/2 when causal) against 989 TFLOP/s
// in bf16; bytes q, k, v and o once each plus lse, against 3.35 TB/s.
// At the served shapes (B = 1, Hq = 32, Hkv = 8, D = 128, causal) the
// bytes bound below S of about 740 and the operations above.
//
// Design. The TPU kernel walks the kv tiles as a sequential grid axis and
// carries m, l and acc in VMEM scratch between grid steps; on Hopper the
// blocks of a grid run in no order, so one block owns a 64-row query tile
// of one head and loops over the kv tiles itself, with m, l and acc in
// registers. Blocks are launched longest-causal-row first so the
// diagonal's short tiles fill the tail of the grid.
//  - bf16: four warps, 16 query rows each, mma.sync m16n8k16 with f32
//    accumulation for both Q.K^T and P.V. K and V tiles of 64 keys stream
//    into shared memory by cp.async in two stages, so the next tile's load
//    runs under this tile's math; ldmatrix hands out their B fragments
//    (transposed for V). The S tile's accumulator fragments are re-packed
//    in registers as the A operand of P.V, so the probabilities never
//    touch shared memory. The softmax runs in base 2 (scores scaled by
//    log2 e), which is the same function.
//  - f32: CUDA-core FMAs in f32 throughout (tensor cores would round the
//    inputs to tf32 or bf16), four threads per query row, each owning a
//    quarter of the head dims.
// wgmma and TMA are left for a later revision.

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------- bf16 --

constexpr int kBQ = 64;       // query rows per block, 16 per warp
constexpr int kBK = 64;       // keys per kv tile
constexpr int kThreadsBf16 = 128;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory of the bf16 kernel: two stages of a K and a V tile.
template <int D>
constexpr int bf16_smem_bytes() {
  return 2 * 2 * kBK * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
fa_fwd_bf16(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
            int Hq, int Hkv, Strides sq, Strides sk, Strides sv, Strides so,
            float scale, int causal) {
  constexpr int ST = D + 8;  // tile row stride: conflict-free ldmatrix
  constexpr int TILE = kBK * ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][TILE]
  __nv_bfloat16* v_s = k_s + 2 * TILE;                               // [2][TILE]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group id, thread in group
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kvh * sv.h;

  auto load_tile = [&](int stage, int k0) {
    constexpr int VEC = D / 8;  // 16-byte vectors per row
    for (int i = tid; i < kBK * VEC; i += kThreadsBf16) {
      const int r = i / VEC, c8 = (i % VEC) * 8, key = k0 + r;
      const bool ok = key < S;
      const long long row = ok ? key : 0;
      cp_async16(k_s + stage * TILE + r * ST + c8, kb + row * sk.s + c8, ok);
      cp_async16(v_s + stage * TILE + r * ST + c8, vb + row * sv.s + c8, ok);
    }
    cp_async_commit();
  };

  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  load_tile(0, 0);

  // Rows g and g + 8 of this warp's 16: the rows of the C fragments.
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qf[D / 16][4];  // Q as A fragments, one per 16-wide dim chunk
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const int d0 = c * 16 + t * 2;
    qf[c][0] = r0 < S ? ld32(qb + r0 * sq.s + d0) : 0u;
    qf[c][1] = r1 < S ? ld32(qb + r1 * sq.s + d0) : 0u;
    qf[c][2] = r0 < S ? ld32(qb + r0 * sq.s + d0 + 8) : 0u;
    qf[c][3] = r1 < S ? ld32(qb + r1 * sq.s + d0 + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // Running max of rows r0, r1 in log2 units (p = 2^(s*scale*log2e - m)),
  // and this thread's share of their running sums.
  float m0 = kMaskFill, m1 = kMaskFill, l0 = 0.f, l1 = 0.f;
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK;
    if (it + 1 < n_tiles) {  // the next tile streams in under this one
      load_tile((it + 1) & 1, k0 + kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every warp
    const __nv_bfloat16* ks = k_s + (it & 1) * TILE;
    const __nv_bfloat16* vs = v_s + (it & 1) * TILE;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; c += 2) {
        uint32_t kf[4];  // B fragments of dim chunks c and c + 1
        ldsm_x4(kf, ks + (j * 8 + (lane & 7)) * ST + c * 16 + (lane >> 3) * 8);
        mma_bf16(s[j], qf[c], kf[0], kf[1]);
        mma_bf16(s[j], qf[c + 1], kf[2], kf[3]);
      }
    }

    // Only tiles on the diagonal or the ragged end need the mask.
    const bool edge = k0 + kBK > S || (causal && k0 + kBK > q0);
    float mx0 = kMaskFill, mx1 = kMaskFill;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = s[j][e] * sl2, c = s[j][2 + e] * sl2;
        if (edge) {
          const int key = k0 + j * 8 + t * 2 + e;
          if (key >= S || (causal && key > r0)) a = kMaskFill;
          if (key >= S || (causal && key > r1)) c = kMaskFill;
        }
        s[j][e] = a;
        s[j][2 + e] = c;
        mx0 = fmaxf(mx0, a);
        mx1 = fmaxf(mx1, c);
      }
    }
    // The four threads of a group hold one row between them.
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // acc += P V: the C fragments of key columns [16kc, 16kc + 16) are
    // exactly the A fragment of that 16-key chunk; V's B fragments are
    // transposed 8x8 blocks of the row-major V tile.
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const int mi = lane >> 3;
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t vf[4];  // B fragments of dim tiles n and n + 1
        ldsm_x4_trans(vf, vs + (kc * 16 + (mi & 1) * 8 + (lane & 7)) * ST +
                              (n + (mi >> 1)) * 8);
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before a refill
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + t * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * so.s + d) =
          pack_bf16(acc[n][0] / den0, acc[n][1] / den0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * so.s + d) =
          pack_bf16(acc[n][2] / den1, acc[n][3] / den1);
  }
  if (t == 0) {
    float* lb = lse + static_cast<long long>(bh) * S;
    if (r0 < S) lb[r0] = m0 * kLn2 + logf(den0);
    if (r1 < S) lb[r1] = m1 * kLn2 + logf(den1);
  }
}

// ----------------------------------------------------------------- f32 --

constexpr int kSBQ = 64;  // query rows per block, four threads per row
constexpr int kSBK = 32;  // keys per kv tile
constexpr int kThreadsF32 = 256;

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int S, int Hq, int Hkv, Strides sq,
           Strides sk, Strides sv, Strides so, float scale, int causal) {
  constexpr int DT = D / 4;  // head dims per thread: d = 4 * j + part
  __shared__ float k_s[kSBK][D];
  __shared__ float v_s[kSBK][D];

  const int tid = threadIdx.x, part = tid & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kSBQ;
  const int r = q0 + (tid >> 2);
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  float qr[DT], acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    qr[j] = r < S ? qb[r * sq.s + 4 * j + part] : 0.f;
    acc[j] = 0.f;
  }
  float m = kMaskFill, l = 0.f;

  const int kv_end = causal ? min(S, q0 + kSBQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kSBK) {
    __syncthreads();
    for (int i = tid; i < kSBK * D; i += kThreadsF32) {
      const int rr = i / D, d = i % D, key = k0 + rr;
      k_s[rr][d] = key < S ? kb[key * sk.s + d] : 0.f;
      v_s[rr][d] = key < S ? vb[key * sv.s + d] : 0.f;
    }
    __syncthreads();

    float s[kSBK];
    float mx = kMaskFill;
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < DT; ++j) dot = fmaf(qr[j], k_s[kk][4 * j + part], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int key = k0 + kk;
      float sc = dot * scale;
      if (key >= S || (causal && key > r)) sc = kMaskFill;
      s[kk] = sc;
      mx = fmaxf(mx, sc);
    }
    const float mn = fmaxf(m, mx), al = expf(m - mn);
    float ps = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      s[kk] = expf(s[kk] - mn);
      ps += s[kk];
    }
    l = l * al + ps;
    m = mn;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      float a = acc[j] * al;
#pragma unroll
      for (int kk = 0; kk < kSBK; ++kk) a = fmaf(s[kk], v_s[kk][4 * j + part], a);
      acc[j] = a;
    }
  }

  if (r < S) {
    const float den = fmaxf(l, 1e-30f);
    float* ob = o + b * so.b + h * so.h + r * so.s;
#pragma unroll
    for (int j = 0; j < DT; ++j) ob[4 * j + part] = acc[j] / den;
    if (part == 0) lse[static_cast<long long>(bh) * S + r] = m + logf(den);
  }
}

template <int D>
cudaError_t launch(int dtype, dim3 grid, cudaStream_t st, const void* q,
                   const void* k, const void* v, void* o, float* lse, int S,
                   int Hq, int Hkv, Strides sq, Strides sk, Strides sv,
                   Strides so, float scale, int causal) {
  if (dtype == 1) {
    constexpr int smem = bf16_smem_bytes<D>();
    // Above 48 KB needs the opt-in, which holds for the current device
    // only, so it is set on every launch.
    const cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    grid.x = (S + kBQ - 1) / kBQ;
    fa_fwd_bf16<D><<<grid, kThreadsBf16, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), lse, S, Hq, Hkv, sq, sk, sv, so,
        scale, causal);
  } else {
    grid.x = (S + kSBQ - 1) / kSBQ;
    fa_fwd_f32<D><<<grid, kThreadsF32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, S, Hq,
        Hkv, sq, sk, sv, so, scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launch (0 on success); runs on `stream`, no sync.
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int dtype, int B, int S, int Hq, int Hkv,
                      int D, long long sq_b, long long sq_s, long long sq_h,
                      long long sk_b, long long sk_s, long long sk_h,
                      long long sv_b, long long sv_s, long long sv_h,
                      long long so_b, long long so_s, long long so_h,
                      float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sq_b, sq_s, sq_h}, sk{sk_b, sk_s, sk_h},
      sv{sv_b, sv_s, sv_h}, so{so_b, so_s, so_h};
  const dim3 grid(1, B * Hq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D == 64)
    return static_cast<int>(launch<64>(dtype, grid, st, q, k, v, o, l, S, Hq,
                                       Hkv, sq, sk, sv, so, scale, causal));
  if (D == 128)
    return static_cast<int>(launch<128>(dtype, grid, st, q, k, v, o, l, S,
                                        Hq, Hkv, sq, sk, sv, so, scale,
                                        causal));
  return static_cast<int>(cudaErrorInvalidValue);
}
