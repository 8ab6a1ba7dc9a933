// Flash-attention backward, dK and dV, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py:_fa_dkv_kernel,
// launched there by _flash_backward_pallas. It computes the same function:
// with P = exp(Q.K^T * scale - lse) recomputed from the forward's row
// logsumexp (the causal part masked to 0), dV = P^T.dO and
// dK = (P * (dO.V^T - delta))^T.Q * scale, accumulated in f32 over the
// query tiles from the diagonal on. The reference emits dK and dV per
// query head in f32 and sums each GQA group outside the kernel; here the
// group sum runs inside, so dK and dV are written once per kv head, in the
// input type, with no f32 intermediates and no atomics.
//
// Layout: q, dO (B, S, Hq, D) and k, v, dK, dV (B, S, Hkv, D), read and
// written through their batch/sequence/head strides (the last dim is
// contiguous); lse and delta are (B, Hq, S) f32. Kv head j serves query
// heads j * G .. j * G + G - 1, G = Hq / Hkv.
//
// What bounds it on an H100 SXM: operations 8*B*Hq*D*P with P the live
// (query, key) pairs (four products per pair) against 989 TFLOP/s in
// bf16; bytes q, k, v, dO, dK and dV once each plus lse and delta, against
// 3.35 TB/s.
//
// Design. One block owns a 64-row tile of one kv head and keeps dK and dV
// in registers while it loops over the G query heads of its group and, in
// each, over the query tiles at or after its diagonal (a kv tile sees the
// queries after it, not before).
//  - bf16: four warps of 16 kv rows. K and V stay in shared memory and
//    give their mma A fragments through ldmatrix; query tiles of Q and dO,
//    with their rows' lse and delta, stream in by cp.async in two stages.
//    Per query tile: S^T = K.Q^T, P^T in registers, dV += P^T.dO,
//    dP^T = V.dO^T, dS^T = P^T * (dP^T - delta), dK += dS^T.Q, each an
//    mma.sync m16n8k16 product with f32 accumulation; P^T and dS^T are
//    re-packed in registers as A operands. The dK and dV accumulators hold
//    2 * 16 * D f32 values per warp; at D = 128 that is 128 registers a
//    thread, so the query tile is 32 rows, which keeps S^T and dP^T at 16
//    registers each and the kernel clear of spills.
//  - f32: CUDA-core FMAs in f32, four threads per kv row, each owning a
//    quarter of the head dims of k, v, dK and dV, query by query over
//    tiles of 32 query rows.
// wgmma and TMA are left for a later revision.

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------- bf16 --

constexpr int kBK = 64;  // kv rows per block, 16 per warp
constexpr int kQT = 32;  // query rows per step of the loop
constexpr int kThreadsBf16 = 128;

// Dynamic shared memory: the K and V tiles, then two stages of a Q and a
// dO tile, then two stages of the query rows' lse and delta.
template <int D>
constexpr int bf16_smem_bytes() {
  return (2 * kBK + 4 * kQT) * (D + 8) *
             static_cast<int>(sizeof(__nv_bfloat16)) +
         4 * kQT * static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
fa_dkv_bf16(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int S, int Hq, int Hkv, Strides sq, Strides sk, Strides sv,
            Strides sdo, Strides sdk, Strides sdv, float scale, int causal) {
  constexpr int ST = D + 8;  // tile row stride: conflict-free ldmatrix
  constexpr int QTILE = kQT * ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBK][ST]
  __nv_bfloat16* v_s = k_s + kBK * ST;                               // [kBK][ST]
  __nv_bfloat16* q_s = v_s + kBK * ST;                               // [2][QTILE]
  __nv_bfloat16* do_s = q_s + 2 * QTILE;                             // [2][QTILE]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * QTILE);         // [2][kQT]
  float* dl_s = lse_s + 2 * kQT;                                     // [2][kQT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group id, thread in group
  const int k0 = blockIdx.x * kBK;
  const int bkv = blockIdx.y, b = bkv / Hkv, kvh = bkv % Hkv;
  const int G = Hq / Hkv;
  const __nv_bfloat16* kb = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kvh * sv.h;
  constexpr int VEC = D / 8;  // 16-byte vectors per row

  for (int i = tid; i < kBK * VEC; i += kThreadsBf16) {
    const int r = i / VEC, c8 = (i % VEC) * 8, key = k0 + r;
    const bool ok = key < S;
    const long long row = ok ? key : 0;
    cp_async16(k_s + r * ST + c8, kb + row * sk.s + c8, ok);
    cp_async16(v_s + r * ST + c8, vb + row * sv.s + c8, ok);
  }

  // Query tiles: G heads, each from the diagonal (causal) or 0 to S.
  const int q_start = causal ? k0 : 0;
  const int n_qt = (S - q_start + kQT - 1) / kQT;
  const int n_it = G * n_qt;
  auto load_q = [&](int stage, int it) {
    const int h = kvh * G + it / n_qt;
    const int qi0 = q_start + (it % n_qt) * kQT;
    const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
    const __nv_bfloat16* dob = dout + b * sdo.b + h * sdo.h;
    for (int i = tid; i < kQT * VEC; i += kThreadsBf16) {
      const int r = i / VEC, c8 = (i % VEC) * 8, qr = qi0 + r;
      const bool ok = qr < S;
      const long long row = ok ? qr : 0;
      cp_async16(q_s + stage * QTILE + r * ST + c8, qb + row * sq.s + c8, ok);
      cp_async16(do_s + stage * QTILE + r * ST + c8, dob + row * sdo.s + c8,
                 ok);
    }
    if (tid < kQT) {
      const int qr = qi0 + tid;
      const bool ok = qr < S;
      const long long row = (static_cast<long long>(b) * Hq + h) * S +
                            (ok ? qr : 0);
      cp_async4(lse_s + stage * kQT + tid, lse + row, ok);
      cp_async4(dl_s + stage * kQT + tid, delta + row, ok);
    }
    cp_async_commit();
  };
  load_q(0, 0);  // one group with the K and V tiles

  // Rows g and g + 8 of this warp's 16 kv rows: the rows of the C fragments.
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  const float sl2 = scale * kLog2e;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {  // the next query tile streams in under this one
      load_q((it + 1) & 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every warp
    const int qi0 = q_start + (it % n_qt) * kQT;
    const __nv_bfloat16* qs = q_s + (it & 1) * QTILE;
    const __nv_bfloat16* dos = do_s + (it & 1) * QTILE;
    const float* ls = lse_s + (it & 1) * kQT;
    const float* dls = dl_s + (it & 1) * kQT;

    // S^T = K Q^T for this warp's 16 kv rows and the tile's kQT queries.
    float st[kQT / 8][4];
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j)
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; c += 2) {
      uint32_t a0[4], a1[4];
      lds_a<ST>(a0, k_s, warp * 16, c * 16, lane);
      lds_a<ST>(a1, k_s, warp * 16, c * 16 + 16, lane);
#pragma unroll
      for (int j = 0; j < kQT / 8; ++j) {
        uint32_t bf[4];
        lds_b_nt<ST>(bf, qs, j * 8, c * 16, lane);
        mma_bf16(st[j], a0, bf[0], bf[1]);
        mma_bf16(st[j], a1, bf[2], bf[3]);
      }
    }

    // P^T = 2^(S^T scale log2e - lse log2e), 0 where masked. Only tiles
    // that cross the diagonal or the ragged end mask.
    const bool edge = qi0 + kQT > S || (causal && qi0 < k0 + kBK);
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + t * 2 + e, qr = qi0 + col;
        const float l2 = ls[col] * kLog2e;
        float p0 = exp2f(st[j][e] * sl2 - l2);
        float p1 = exp2f(st[j][2 + e] * sl2 - l2);
        if (edge) {
          if (qr >= S || (causal && qr < r0)) p0 = 0.f;
          if (qr >= S || (causal && qr < r1)) p1 = 0.f;
        }
        st[j][e] = p0;
        st[j][2 + e] = p1;
      }
    }

    // dV += P^T dO: P^T's C fragments of query columns [16kc, 16kc + 16)
    // are the A fragment of that chunk; dO's B fragments come transposed
    // from the row-major dO tile.
#pragma unroll
    for (int kc = 0; kc < kQT / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kc][0], st[2 * kc][1]),
                              pack_bf16(st[2 * kc][2], st[2 * kc][3]),
                              pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                              pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bf[4];
        lds_b_t<ST>(bf, dos, kc * 16, n * 8, lane);
        mma_bf16(dva[n], pa, bf[0], bf[1]);
        mma_bf16(dva[n + 1], pa, bf[2], bf[3]);
      }
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) overwrites P^T.
    float dpt[kQT / 8][4];
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j)
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; c += 2) {
      uint32_t a0[4], a1[4];
      lds_a<ST>(a0, v_s, warp * 16, c * 16, lane);
      lds_a<ST>(a1, v_s, warp * 16, c * 16 + 16, lane);
#pragma unroll
      for (int j = 0; j < kQT / 8; ++j) {
        uint32_t bf[4];
        lds_b_nt<ST>(bf, dos, j * 8, c * 16, lane);
        mma_bf16(dpt[j], a0, bf[0], bf[1]);
        mma_bf16(dpt[j], a1, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = dls[j * 8 + t * 2 + e];
        st[j][e] *= dpt[j][e] - dl;
        st[j][2 + e] *= dpt[j][2 + e] - dl;
      }
    }

    // dK += dS^T Q, with Q's B fragments transposed from the Q tile.
#pragma unroll
    for (int kc = 0; kc < kQT / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kc][0], st[2 * kc][1]),
                              pack_bf16(st[2 * kc][2], st[2 * kc][3]),
                              pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                              pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bf[4];
        lds_b_t<ST>(bf, qs, kc * 16, n * 8, lane);
        mma_bf16(dka[n], pa, bf[0], bf[1]);
        mma_bf16(dka[n + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before a refill
  }

  __nv_bfloat16* dkb = dk + b * sdk.b + kvh * sdk.h;
  __nv_bfloat16* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + t * 2;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(dkb + r0 * sdk.s + d) =
          pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + r0 * sdv.s + d) =
          pack_bf16(dva[n][0], dva[n][1]);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(dkb + r1 * sdk.s + d) =
          pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + r1 * sdv.s + d) =
          pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// ----------------------------------------------------------------- f32 --

constexpr int kSBK = 64;  // kv rows per block, four threads per row
constexpr int kSQT = 32;  // query rows per tile
constexpr int kThreadsF32 = 256;

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
fa_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, int S, int Hq,
           int Hkv, Strides sq, Strides sk, Strides sv, Strides sdo,
           Strides sdk, Strides sdv, float scale, int causal) {
  constexpr int DT = D / 4;  // head dims per thread: d = 4 * j + part
  __shared__ float q_s[kSQT][D];
  __shared__ float do_s[kSQT][D];
  __shared__ float lse_s[kSQT];
  __shared__ float dl_s[kSQT];

  const int tid = threadIdx.x, part = tid & 3;
  const int k0 = blockIdx.x * kSBK;
  const int r = k0 + (tid >> 2);
  const int bkv = blockIdx.y, b = bkv / Hkv, kvh = bkv % Hkv;
  const int G = Hq / Hkv;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  float kr[DT], vr[DT], dka[DT], dva[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    kr[j] = r < S ? kb[r * sk.s + 4 * j + part] : 0.f;
    vr[j] = r < S ? vb[r * sv.s + 4 * j + part] : 0.f;
    dka[j] = dva[j] = 0.f;
  }

  const int q_start = causal ? k0 : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* qb = q + b * sq.b + h * sq.h;
    const float* dob = dout + b * sdo.b + h * sdo.h;
    const float* lb = lse + (static_cast<long long>(b) * Hq + h) * S;
    const float* db = delta + (static_cast<long long>(b) * Hq + h) * S;
    for (int qi0 = q_start; qi0 < S; qi0 += kSQT) {
      __syncthreads();
      for (int i = tid; i < kSQT * D; i += kThreadsF32) {
        const int rr = i / D, d = i % D, qr = qi0 + rr;
        q_s[rr][d] = qr < S ? qb[qr * sq.s + d] : 0.f;
        do_s[rr][d] = qr < S ? dob[qr * sdo.s + d] : 0.f;
      }
      if (tid < kSQT) {
        const int qr = qi0 + tid;
        lse_s[tid] = qr < S ? lb[qr] : 0.f;
        dl_s[tid] = qr < S ? db[qr] : 0.f;
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kSQT; ++qq) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          s = fmaf(kr[j], q_s[qq][4 * j + part], s);
          dp = fmaf(vr[j], do_s[qq][4 * j + part], dp);
        }
        // The four threads of a row hold a quarter of the dot products.
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 2);
        const int qr = qi0 + qq;
        const bool live = qr < S && !(causal && qr < r);
        const float p = live ? expf(s * scale - lse_s[qq]) : 0.f;
        const float ds = p * (dp - dl_s[qq]);
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          dva[j] = fmaf(p, do_s[qq][4 * j + part], dva[j]);
          dka[j] = fmaf(ds, q_s[qq][4 * j + part], dka[j]);
        }
      }
    }
  }

  if (r < S) {
    float* dkr = dk + b * sdk.b + kvh * sdk.h + r * sdk.s;
    float* dvr = dv + b * sdv.b + kvh * sdv.h + r * sdv.s;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      dkr[4 * j + part] = dka[j] * scale;
      dvr[4 * j + part] = dva[j];
    }
  }
}

template <int D>
cudaError_t launch(int dtype, dim3 grid, cudaStream_t st, const void* q,
                   const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv,
                   int S, int Hq, int Hkv, Strides sq, Strides sk, Strides sv,
                   Strides sdo, Strides sdk, Strides sdv, float scale,
                   int causal) {
  if (dtype == 1) {
    constexpr int smem = bf16_smem_bytes<D>();
    // Above 48 KB needs the opt-in, which holds for the current device
    // only, so it is set on every launch.
    const cudaError_t err = cudaFuncSetAttribute(
        fa_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    grid.x = (S + kBK - 1) / kBK;
    fa_dkv_bf16<D><<<grid, kThreadsBf16, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S,
        Hq, Hkv, sq, sk, sv, sdo, sdk, sdv, scale, causal);
  } else {
    grid.x = (S + kSBK - 1) / kSBK;
    fa_dkv_f32<D><<<grid, kThreadsF32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), S, Hq, Hkv,
        sq, sk, sv, sdo, sdk, sdv, scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; lse and delta
// are contiguous (B, Hq, S) f32. Returns the cudaError_t of the launch (0 on
// success); runs on `stream`, no sync.
extern "C" int fa_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int dtype, int B, int S, int Hq,
                      int Hkv, int D, long long sq_b, long long sq_s,
                      long long sq_h, long long sk_b, long long sk_s,
                      long long sk_h, long long sv_b, long long sv_s,
                      long long sv_h, long long sdo_b, long long sdo_s,
                      long long sdo_h, long long sdk_b, long long sdk_s,
                      long long sdk_h, long long sdv_b, long long sdv_s,
                      long long sdv_h, float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sq_b, sq_s, sq_h}, sk{sk_b, sk_s, sk_h},
      sv{sv_b, sv_s, sv_h}, sdo{sdo_b, sdo_s, sdo_h}, sdk{sdk_b, sdk_s, sdk_h},
      sdv{sdv_b, sdv_s, sdv_h};
  const dim3 grid(1, B * Hkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D == 64)
    return static_cast<int>(launch<64>(dtype, grid, st, q, k, v, dout, l, dl,
                                       dk, dv, S, Hq, Hkv, sq, sk, sv, sdo,
                                       sdk, sdv, scale, causal));
  if (D == 128)
    return static_cast<int>(launch<128>(dtype, grid, st, q, k, v, dout, l,
                                        dl, dk, dv, S, Hq, Hkv, sq, sk, sv,
                                        sdo, sdk, sdv, scale, causal));
  return static_cast<int>(cudaErrorInvalidValue);
}
