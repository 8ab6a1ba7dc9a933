// Flash-attention backward, dQ, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py:_fa_dq_kernel,
// launched there by _flash_backward_pallas. It computes the same function:
// with P = exp(Q.K^T * scale - lse) recomputed from the forward's row
// logsumexp (the causal part masked to 0), dP = dO.V^T and
// dS = P * (dP - delta), dQ = dS.K * scale, accumulated in f32 over the
// key tiles up to the diagonal and written in the input type. delta =
// rowsum(dO * O) comes in from the caller, as in the reference, where it
// is computed outside the kernel.
//
// Layout: q, dO, dQ (B, S, Hq, D) and k, v (B, S, Hkv, D), read and
// written through their batch/sequence/head strides (the last dim is
// contiguous); lse and delta are (B, Hq, S) f32. Query head h reads kv
// head h / (Hq / Hkv).
//
// What bounds it on an H100 SXM: operations 6*B*Hq*D*P with P the live
// (query, key) pairs (three products per pair) against 989 TFLOP/s in
// bf16; bytes q, k, v, dO and dQ once each plus lse and delta, against
// 3.35 TB/s.
//
// Design. The TPU kernel walks the kv tiles as a sequential grid axis and
// carries dQ in VMEM scratch; here one block owns a 64-row query tile of
// one head and loops over the kv tiles itself, with dQ in registers, so no
// block writes what another reads. Blocks run longest causal row first.
//  - bf16: four warps of 16 query rows. Q and dO stay in registers as
//    mma A fragments for the whole loop (64 registers a thread at D = 128,
//    beside 64 for the dQ accumulator), so the kv tile is 32 keys: S and dP
//    then take 16 registers each and the kernel stays clear of spills.
//    K and V tiles stream into shared memory by cp.async in two stages.
//    Per tile, S = Q.K^T and dP = dO.V^T are mma.sync m16n8k16 products
//    with f32 accumulation (K and V through ldmatrix), P and dS are formed
//    in registers, and dS re-packed to bf16 is the A operand of
//    dQ += dS.K (K through ldmatrix.trans). P runs in base 2 (scores
//    scaled by log2 e).
//  - f32: CUDA-core FMAs in f32, four threads per query row, each owning a
//    quarter of the head dims, key by key over tiles of 32 keys.
// wgmma and TMA are left for a later revision.

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------- bf16 --

constexpr int kBQ = 64;  // query rows per block, 16 per warp
constexpr int kBK = 32;  // keys per kv tile
constexpr int kThreadsBf16 = 128;

// Dynamic shared memory: two stages of a K and a V tile.
template <int D>
constexpr int bf16_smem_bytes() {
  return 2 * 2 * kBK * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
fa_dq_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dq, int S, int Hq, int Hkv, Strides sq,
           Strides sk, Strides sv, Strides sdo, Strides sdq, float scale,
           int causal) {
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
  const __nv_bfloat16* dob = dout + b * sdo.b + h * sdo.h;
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
  uint32_t qf[D / 16][4], df[D / 16][4];  // Q and dO as A fragments
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const int d0 = c * 16 + t * 2;
    qf[c][0] = r0 < S ? ld32(qb + r0 * sq.s + d0) : 0u;
    qf[c][1] = r1 < S ? ld32(qb + r1 * sq.s + d0) : 0u;
    qf[c][2] = r0 < S ? ld32(qb + r0 * sq.s + d0 + 8) : 0u;
    qf[c][3] = r1 < S ? ld32(qb + r1 * sq.s + d0 + 8) : 0u;
    df[c][0] = r0 < S ? ld32(dob + r0 * sdo.s + d0) : 0u;
    df[c][1] = r1 < S ? ld32(dob + r1 * sdo.s + d0) : 0u;
    df[c][2] = r0 < S ? ld32(dob + r0 * sdo.s + d0 + 8) : 0u;
    df[c][3] = r1 < S ? ld32(dob + r1 * sdo.s + d0 + 8) : 0u;
  }
  // The rows' logsumexp in log2 units and their delta.
  const float* lb = lse + static_cast<long long>(bh) * S;
  const float* db = delta + static_cast<long long>(bh) * S;
  const float lse0 = r0 < S ? lb[r0] * kLog2e : 0.f;
  const float lse1 = r1 < S ? lb[r1] * kLog2e : 0.f;
  const float dl0 = r0 < S ? db[r0] : 0.f;
  const float dl1 = r1 < S ? db[r1] : 0.f;
  const float sl2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and the tile's keys.
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; c += 2) {
        uint32_t bf[4];
        lds_b_nt<ST>(bf, ks, j * 8, c * 16, lane);
        mma_bf16(s[j], qf[c], bf[0], bf[1]);
        mma_bf16(s[j], qf[c + 1], bf[2], bf[3]);
        lds_b_nt<ST>(bf, vs, j * 8, c * 16, lane);
        mma_bf16(dp[j], df[c], bf[0], bf[1]);
        mma_bf16(dp[j], df[c + 1], bf[2], bf[3]);
      }
    }

    // P = 2^(S scale log2e - lse log2e), 0 where masked; dS = P (dP - delta)
    // overwrites S. Only tiles on the diagonal or the ragged end mask.
    const bool edge = k0 + kBK > S || (causal && k0 + kBK > q0);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2f(s[j][e] * sl2 - lse0);
        float p1 = exp2f(s[j][2 + e] * sl2 - lse1);
        if (edge) {
          const int key = k0 + j * 8 + t * 2 + e;
          if (key >= S || (causal && key > r0)) p0 = 0.f;
          if (key >= S || (causal && key > r1)) p1 = 0.f;
        }
        s[j][e] = p0 * (dp[j][e] - dl0);
        s[j][2 + e] = p1 * (dp[j][2 + e] - dl1);
      }
    }

    // dQ += dS K: dS's C fragments of key columns [16kc, 16kc + 16) are
    // the A fragment of that chunk; K's B fragments come transposed from
    // the row-major K tile.
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bf[4];
        lds_b_t<ST>(bf, ks, kc * 16, n * 8, lane);
        mma_bf16(acc[n], pa, bf[0], bf[1]);
        mma_bf16(acc[n + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before a refill
  }

  __nv_bfloat16* out = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + t * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + r0 * sdq.s + d) =
          pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + r1 * sdq.s + d) =
          pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// ----------------------------------------------------------------- f32 --

constexpr int kSBQ = 64;  // query rows per block, four threads per row
constexpr int kSBK = 32;  // keys per kv tile
constexpr int kThreadsF32 = 256;

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
fa_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S, int Hq, int Hkv, Strides sq,
          Strides sk, Strides sv, Strides sdo, Strides sdq, float scale,
          int causal) {
  constexpr int DT = D / 4;  // head dims per thread: d = 4 * j + part
  __shared__ float k_s[kSBK][D];
  __shared__ float v_s[kSBK][D];

  const int tid = threadIdx.x, part = tid & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kSBQ;
  const int r = q0 + (tid >> 2);
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  float qr[DT], dor[DT], acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    qr[j] = r < S ? qb[r * sq.s + 4 * j + part] : 0.f;
    dor[j] = r < S ? dob[r * sdo.s + 4 * j + part] : 0.f;
    acc[j] = 0.f;
  }
  const long long row = static_cast<long long>(bh) * S + r;
  const float lr = r < S ? lse[row] : 0.f;
  const float dl = r < S ? delta[row] : 0.f;

  const int kv_end = causal ? min(S, q0 + kSBQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kSBK) {
    __syncthreads();
    for (int i = tid; i < kSBK * D; i += kThreadsF32) {
      const int rr = i / D, d = i % D, key = k0 + rr;
      k_s[rr][d] = key < S ? kb[key * sk.s + d] : 0.f;
      v_s[rr][d] = key < S ? vb[key * sv.s + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kSBK; ++kk) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        s = fmaf(qr[j], k_s[kk][4 * j + part], s);
        dp = fmaf(dor[j], v_s[kk][4 * j + part], dp);
      }
      // The four threads of a row hold a quarter of the dot products each.
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const int key = k0 + kk;
      const bool live = key < S && !(causal && key > r);
      const float ds = live ? expf(s * scale - lr) * (dp - dl) : 0.f;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        acc[j] = fmaf(ds, k_s[kk][4 * j + part], acc[j]);
    }
  }

  if (r < S) {
    float* out = dq + b * sdq.b + h * sdq.h + r * sdq.s;
#pragma unroll
    for (int j = 0; j < DT; ++j) out[4 * j + part] = acc[j] * scale;
  }
}

template <int D>
cudaError_t launch(int dtype, dim3 grid, cudaStream_t st, const void* q,
                   const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int S,
                   int Hq, int Hkv, Strides sq, Strides sk, Strides sv,
                   Strides sdo, Strides sdq, float scale, int causal) {
  if (dtype == 1) {
    constexpr int smem = bf16_smem_bytes<D>();
    // Above 48 KB needs the opt-in, which holds for the current device
    // only, so it is set on every launch.
    const cudaError_t err = cudaFuncSetAttribute(
        fa_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    grid.x = (S + kBQ - 1) / kBQ;
    fa_dq_bf16<D><<<grid, kThreadsBf16, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dq), S, Hq, Hkv, sq, sk, sv, sdo, sdq,
        scale, causal);
  } else {
    grid.x = (S + kSBQ - 1) / kSBQ;
    fa_dq_f32<D><<<grid, kThreadsF32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), S, Hq, Hkv, sq, sk, sv, sdo, sdq,
        scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; lse and delta
// are contiguous (B, Hq, S) f32. Returns the cudaError_t of the launch (0 on
// success); runs on `stream`, no sync.
extern "C" int fa_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int dtype, int B, int S, int Hq, int Hkv, int D,
                     long long sq_b, long long sq_s, long long sq_h,
                     long long sk_b, long long sk_s, long long sk_h,
                     long long sv_b, long long sv_s, long long sv_h,
                     long long sdo_b, long long sdo_s, long long sdo_h,
                     long long sdq_b, long long sdq_s, long long sdq_h,
                     float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sq_b, sq_s, sq_h}, sk{sk_b, sk_s, sk_h},
      sv{sv_b, sv_s, sv_h}, sdo{sdo_b, sdo_s, sdo_h}, sdq{sdq_b, sdq_s, sdq_h};
  const dim3 grid(1, B * Hq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D == 64)
    return static_cast<int>(launch<64>(dtype, grid, st, q, k, v, dout, l, dl,
                                       dq, S, Hq, Hkv, sq, sk, sv, sdo, sdq,
                                       scale, causal));
  if (D == 128)
    return static_cast<int>(launch<128>(dtype, grid, st, q, k, v, dout, l,
                                        dl, dq, S, Hq, Hkv, sq, sk, sv, sdo,
                                        sdq, scale, causal));
  return static_cast<int>(cudaErrorInvalidValue);
}
