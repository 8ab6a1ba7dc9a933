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
// input type, with no f32 intermediates in device memory and no atomics.
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
// Design. A block owns a kv tile and loops over query tiles from the
// diagonal on (a kv row sees the queries after it, not before), with dK
// and dV in registers.
//  - bf16: a 128-row kv tile of one kv head and G / C of its query heads,
//    warp-specialised. One producer warp loads K and V once and streams
//    64-row Q and dO tiles through a two-stage ring by TMA (hopper.cuh;
//    rows past S arrive as zeros), and writes the rows' lse (in log2
//    units) and delta beside them; full and empty mbarriers guard the
//    slots. Two consumer warpgroups own 64 kv rows each. Per query tile,
//    S^T = K.Q^T and dP^T = V.dO^T are wgmma products with both operands
//    in shared memory; P^T = 2^(S^T scale log2e - lse log2e) and
//    dS^T = P^T (dP^T - delta) are formed in registers, and packed to bf16
//    they are the A operands of dV += P^T.dO and dK += dS^T.Q, with dO
//    and Q read as transposed (MN-major) B; dS^T is formed while dV's
//    products run. setmaxnreg moves registers from the producer (24) to the
//    consumers (240).
//    GQA: the G query heads of a group are split over a thread-block
//    cluster of C blocks, C the largest divisor of G that is at most 8,
//    each looping over G / C heads. After the loop each block stages its
//    f32 dK and dV in its own shared memory, over the tiles it no longer
//    needs; after a cluster barrier, rank r sums rows [r 128 / C,
//    (r + 1) 128 / C) over ranks 0 .. C - 1 in that order through
//    distributed shared memory, scales dK and writes bf16, and a last
//    cluster barrier keeps every block alive until all have read. The sum
//    is in a fixed order, so dK and dV are bit-identical from run to run.
//    The grid is (B Hkv C) x (S / 128), kv tile 0, the longest under the
//    causal mask, first: at S = 2048, Hq = 32, Hkv = 8 that is 512 blocks,
//    the longest walking 32 query tiles of one head.
//  - f32: CUDA-core FMAs in f32, four threads per kv row, each owning a
//    quarter of the head dims of k, v, dK and dV, query by query over
//    tiles of 32 query rows.
// Left for later: ping-pong scheduling of the two warpgroups, persistent
// blocks, dK and dV written through TMA, fp8.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- bf16 --

constexpr int kBKV = 128;      // kv rows per block, 64 per consumer
constexpr int kBQ = 64;        // query rows per step of the loop
constexpr int kStages = 2;     // Q/dO ring slots
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreadsBf16 = (kConsumers + 1) * 128;
constexpr int kMaxCluster = 8;  // the portable cluster size

// Dynamic shared memory of the bf16 kernel, byte offsets from a 1024-byte
// aligned base. The loop's tiles (each D / 64 panels of [rows][64] bf16):
// K, V, then kStages Q and kStages dO tiles, then kStages rows of lse and
// of delta. After the loop the same bytes hold the block's f32 dK and dV,
// rows padded to D + 8 floats. The mbarriers follow both: kv_full, and
// full and empty per slot.
template <int D>
struct DkvSmem {
  static constexpr int kKVBytes = kBKV * D * 2;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kLse = kDO + kStages * kQBytes;
  static constexpr int kDelta = kLse + kStages * kBQ * 4;
  static constexpr int kLoopEnd = kDelta + kStages * kBQ * 4;
  static constexpr int kRow = D + 8;  // floats per staged row
  static constexpr int kStagedEnd = 2 * kBKV * kRow * 4;
  static constexpr int kBar = kLoopEnd > kStagedEnd ? kLoopEnd : kStagedEnd;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// Barrier over the consumer warpgroups only (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
fa_dkv_bf16(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int S, int Hq, int Hkv, Strides sdk, Strides sdv, float scale,
            int causal) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base_1024(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t kv_full = base + L::kBar;
  const uint32_t full = kv_full + 8;           // [kStages]
  const uint32_t empty = full + 8 * kStages;   // [kStages]

  const int tid = threadIdx.x, wg = warpgroup_index();
  const int C = cluster_size(), rank = cluster_rank();
  const int G = Hq / Hkv, heads = G / C;  // query heads per block
  const int bkv = blockIdx.x / C, b = bkv / Hkv, kvh = bkv % Hkv;
  const int h0 = kvh * G + rank * heads;
  const int k0 = blockIdx.y * kBKV;
  const int q_start = causal ? k0 : 0;
  const int n_qt = (S - q_start + kBQ - 1) / kBQ;
  const int n_it = heads * n_qt;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer warpgroup; its first warp feeds the ring.
    setmaxnreg_dec<24>();
    const int lane = tid & 31;
    if (tid / 32 == kConsumers * 4) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * L::kKVBytes);
        for (int p = 0; p < D / 64; ++p) {
          tma_load_4d(base + L::kK + p * kBKV * 128, &tk, kv_full, p * 64,
                      kvh, k0, b);
          tma_load_4d(base + L::kV + p * kBKV * 128, &tv, kv_full, p * 64,
                      kvh, k0, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int h = h0 + it / n_qt;
        const int qi0 = q_start + (it % n_qt) * kBQ;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * L::kQBytes);
          for (int p = 0; p < D / 64; ++p) {
            tma_load_4d(base + L::kQ + s * L::kQBytes + p * kBQ * 128, &tq,
                        full + 8 * s, p * 64, h, qi0, b);
            tma_load_4d(base + L::kDO + s * L::kQBytes + p * kBQ * 128, &tdo,
                        full + 8 * s, p * 64, h, qi0, b);
          }
        }
        // The rows' lse (in log2 units) and delta, two per lane; the slot
        // completes when all 32 lanes have arrived and the tiles landed.
        const long long row = (static_cast<long long>(b) * Hq + h) * S;
        float* ls = reinterpret_cast<float*>(smem + L::kLse) + s * kBQ;
        float* dl = reinterpret_cast<float*>(smem + L::kDelta) + s * kBQ;
#pragma unroll
        for (int e = 0; e < kBQ / 32; ++e) {
          const int i = lane + 32 * e, qr = qi0 + i;
          ls[i] = qr < S ? lse[row + qr] * kLog2e : 0.f;
          dl[i] = qr < S ? delta[row + qr] : 0.f;
        }
        mbar_arrive(full + 8 * s);
      }
    }
    cluster_sync();  // every block's partial dK and dV are staged
    cluster_sync();  // and every block has read what it sums
  } else {
    // Consumer warpgroup wg: kv rows kv0 .. kv0 + 63.
    setmaxnreg_inc<240>();
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kv0 = k0 + wg * 64;
    // Rows g and g + 8 of this warp's 16: the kv rows of its accumulators.
    const int r0 = kv0 + warp * 16 + g, r1 = r0 + 8;
    const uint32_t ka = base + L::kK + wg * 64 * 128;
    const uint32_t va = base + L::kV + wg * 64 * 128;
    const float sl2 = scale * kLog2e;
    const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse);
    const float* dl_s = reinterpret_cast<const float*>(smem + L::kDelta);

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int qi0 = q_start + (it % n_qt) * kBQ;
      const uint32_t qs = base + L::kQ + s * L::kQBytes;
      const uint32_t dos = base + L::kDO + s * L::kQBytes;
      const float* ls = lse_s + s * kBQ;
      const float* dls = dl_s + s * kBQ;

      // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 kv rows and
      // the tile's 64 queries, reduced over D.
      float st[kBQ / 2], dpt[kBQ / 2];
      const uint64_t kd = opaque(sw128_desc(ka, 16, 1024));
      const uint64_t vd = opaque(sw128_desc(va, 16, 1024));
      const uint64_t qd = opaque(sw128_desc(qs, 16, 1024));
      const uint64_t dod = opaque(sw128_desc(dos, 16, 1024));
      mbar_wait(full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<kBQ, 0>(st, desc_add(kd, (kk / 4) * kBKV * 128 + off),
                         desc_add(qd, (kk / 4) * kBQ * 128 + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<kBQ, 0>(dpt, desc_add(vd, (kk / 4) * kBKV * 128 + off),
                         desc_add(dod, (kk / 4) * kBQ * 128 + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      // P^T = 2^(S^T scale log2e - lse log2e), 0 where masked. Only tiles
      // that cross the diagonal or the ragged end mask.
      const bool edge = qi0 + kBQ > S || (causal && qi0 < kv0 + 63);
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + t * 2 + e, qr = qi0 + col;
          const float l2 = ls[col];
          float p0 = exp2f(st[4 * j + e] * sl2 - l2);
          float p1 = exp2f(st[4 * j + 2 + e] * sl2 - l2);
          if (edge) {
            if (qr >= S || (causal && qr < r0)) p0 = 0.f;
            if (qr >= S || (causal && qr < r1)) p1 = 0.f;
          }
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
        }
      }

      // dV += P^T dO: P^T's accumulators, packed to bf16, are the A
      // operands; dO's 16-row steps are 2048 bytes apart, its 64-column
      // panels kBQ * 128 bytes.
      uint32_t pa[kBQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc) acc_to_a(pa[kc], st, kc);
      const uint64_t dot = opaque(sw128_desc(dos, kBQ * 128, 1024));
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc)
        wgmma_rs<D, 1>(dva, pa[kc], desc_add(dot, kc * 2048), 1);
      wgmma_commit();

      // dS^T = P^T (dP^T - delta) overwrites dP^T while dV's products run;
      // then dK += dS^T Q, Q read as dO was.
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = dls[j * 8 + t * 2 + e];
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl);
          dpt[4 * j + 2 + e] = st[4 * j + 2 + e] * (dpt[4 * j + 2 + e] - dl);
        }
      }
      uint32_t da[kBQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc) acc_to_a(da[kc], dpt, kc);
      const uint64_t qt = opaque(sw128_desc(qs, kBQ * 128, 1024));
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc)
        wgmma_rs<D, 1>(dka, da[kc], desc_add(qt, kc * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dva);
      reg_fence(dka);
      mbar_arrive(empty + 8 * s);  // this thread is done with slot s
    }

    // Stage the block's partial sums in f32 over the tiles: first both
    // consumer warpgroups leave the loop (all its loads have landed).
    consumers_sync();
    fence_proxy_async();
    constexpr int R = L::kRow;
    float* stk = reinterpret_cast<float*>(smem);
    float* stv = stk + kBKV * R;
    const int lr0 = wg * 64 + warp * 16 + g, lr1 = lr0 + 8;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + t * 2;
      *reinterpret_cast<float2*>(stk + lr0 * R + c) =
          make_float2(dka[4 * n], dka[4 * n + 1]);
      *reinterpret_cast<float2*>(stk + lr1 * R + c) =
          make_float2(dka[4 * n + 2], dka[4 * n + 3]);
      *reinterpret_cast<float2*>(stv + lr0 * R + c) =
          make_float2(dva[4 * n], dva[4 * n + 1]);
      *reinterpret_cast<float2*>(stv + lr1 * R + c) =
          make_float2(dva[4 * n + 2], dva[4 * n + 3]);
    }
    cluster_sync();

    // Rank `rank` sums its share of the rows over the cluster's blocks in
    // rank order and writes them.
    const int lo = rank * kBKV / C, hi = (rank + 1) * kBKV / C;
    const uint32_t stk_a = base, stv_a = base + kBKV * R * 4;
    __nv_bfloat16* dkb = dk + b * sdk.b + kvh * sdk.h;
    __nv_bfloat16* dvb = dv + b * sdv.b + kvh * sdv.h;
    constexpr int V4 = D / 4;  // float4s per row
    for (int i = tid; i < (hi - lo) * V4; i += kConsumers * 128) {
      const int row = lo + i / V4, c = (i % V4) * 4, kr = k0 + row;
      if (kr >= S) continue;
      const uint32_t off = (row * R + c) * 4;
      float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
      for (int src = 0; src < C; ++src) {
        const float4 a = ld_cluster_f4(map_rank(stk_a + off, src));
        const float4 w = ld_cluster_f4(map_rank(stv_a + off, src));
        sk.x += a.x;
        sk.y += a.y;
        sk.z += a.z;
        sk.w += a.w;
        sv.x += w.x;
        sv.y += w.y;
        sv.z += w.z;
        sv.w += w.w;
      }
      *reinterpret_cast<uint2*>(dkb + kr * sdk.s + c) =
          make_uint2(pack_bf16(sk.x * scale, sk.y * scale),
                     pack_bf16(sk.z * scale, sk.w * scale));
      *reinterpret_cast<uint2*>(dvb + kr * sdv.s + c) =
          make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
    }
    cluster_sync();  // no block leaves while another reads its shared memory
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

// The cluster size of a GQA group of G query heads: the largest divisor of
// G that is at most kMaxCluster.
inline int group_cluster(int G) {
  for (int c = kMaxCluster; c > 1; --c)
    if (G % c == 0) return c;
  return 1;
}

template <int D>
cudaError_t launch_bf16(cudaStream_t st, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int B, int S,
                        int Hq, int Hkv, Strides sq, Strides sk, Strides sv,
                        Strides sdo, Strides sdk, Strides sdv, float scale,
                        int causal) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bf16_tensor_map(&tq, q, B, S, Hq, D, sq, kBQ);
  if (err == cudaSuccess)
    err = bf16_tensor_map(&tk, k, B, S, Hkv, D, sk, kBKV);
  if (err == cudaSuccess)
    err = bf16_tensor_map(&tv, v, B, S, Hkv, D, sv, kBKV);
  if (err == cudaSuccess)
    err = bf16_tensor_map(&tdo, dout, B, S, Hq, D, sdo, kBQ);
  if (err != cudaSuccess) return err;
  constexpr int smem = DkvSmem<D>::kBytes;
  // Above 48 KB needs the opt-in, which holds for the current device
  // only, so it is set on every launch.
  err = cudaFuncSetAttribute(
      fa_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // The cluster size is known only here, so the launch names it.
  const int C = group_cluster(Hq / Hkv);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * C, (S + kBKV - 1) / kBKV);
  cfg.blockDim = dim3(kThreadsBf16);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fa_dkv_bf16<D>, tq, tk, tv, tdo, lse, delta,
                           static_cast<__nv_bfloat16*>(dk),
                           static_cast<__nv_bfloat16*>(dv), S, Hq, Hkv, sdk,
                           sdv, scale, causal);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, cudaStream_t st, const void* q, const void* k,
                   const void* v, const void* dout, const float* lse,
                   const float* delta, void* dk, void* dv, int B, int S,
                   int Hq, int Hkv, Strides sq, Strides sk, Strides sv,
                   Strides sdo, Strides sdk, Strides sdv, float scale,
                   int causal) {
  if (dtype == 1)
    return launch_bf16<D>(st, q, k, v, dout, lse, delta, dk, dv, B, S, Hq,
                          Hkv, sq, sk, sv, sdo, sdk, sdv, scale, causal);
  const dim3 grid((S + kSBK - 1) / kSBK, B * Hkv);
  fa_dkv_f32<D><<<grid, kThreadsF32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), S, Hq, Hkv,
      sq, sk, sv, sdo, sdk, sdv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; lse and delta
// are contiguous (B, Hq, S) f32. Returns the cudaError_t of the tensor-map
// encode or the launch (0 on success); runs on `stream`, no sync.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D == 64)
    return static_cast<int>(launch<64>(dtype, st, q, k, v, dout, l, dl, dk,
                                       dv, B, S, Hq, Hkv, sq, sk, sv, sdo,
                                       sdk, sdv, scale, causal));
  if (D == 128)
    return static_cast<int>(launch<128>(dtype, st, q, k, v, dout, l, dl, dk,
                                        dv, B, S, Hq, Hkv, sq, sk, sv, sdo,
                                        sdk, sdv, scale, causal));
  return static_cast<int>(cudaErrorInvalidValue);
}
