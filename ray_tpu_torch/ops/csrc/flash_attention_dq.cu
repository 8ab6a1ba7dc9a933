// Flash-attention backward, dQ, for NVIDIA Hopper (sm_90a), with delta =
// rowsum(dO * O) computed in the same kernel.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py:_fa_dq_kernel,
// launched there by _flash_backward_pallas. It computes the same function:
// with P = exp(Q.K^T * scale - lse) recomputed from the forward's row
// logsumexp (the causal part masked to 0), dP = dO.V^T and
// dS = P * (dP - delta), dQ = dS.K * scale, accumulated in f32 over the
// key tiles up to the diagonal and written in the input type. The
// reference computes delta outside its kernels, as a plain sum
// (ray_tpu/ops/flash_attention.py:270); here the dQ kernel computes the
// same function in its prologue and writes it out for the dK/dV kernel,
// which runs next on the same stream, so no separate pass reads dO and O.
//
// Layout: q, o, dO, dQ (B, S, Hq, D) and k, v (B, S, Hkv, D), read and
// written through their batch/sequence/head strides (the last dim is
// contiguous); lse (read) and delta (written) are (B, Hq, S) f32. Query
// head h reads kv head h / (Hq / Hkv).
//
// What bounds it on an H100 SXM: operations 6*B*Hq*D*P with P the live
// (query, key) pairs (three products per pair) against 989 TFLOP/s in
// bf16; bytes q, k, v, o, dO and dQ once each plus lse and delta, against
// 3.35 TB/s. At the trained shapes (S = 2048, D = 128, causal) the
// operations bound it.
//
// Design. The TPU kernel walks the kv tiles as a sequential grid axis and
// carries dQ in VMEM scratch; here one block owns a query tile of one head
// and loops over the kv tiles itself, with dQ in registers, so no block
// writes what another reads. Blocks run longest causal row first.
//  - bf16: a 128-row query tile per block, warp-specialised as the dK/dV
//    kernel is. One producer thread issues TMA (hopper.cuh): the block's
//    Q and dO tiles once, then 64-key K and V tiles into a two-stage ring
//    whose slots are guarded by full and empty mbarriers; rows past S
//    arrive as zeros. Two consumer warpgroups own 64 query rows each.
//    While the first loads are in flight, each consumer computes delta for
//    its rows: the four threads that share rows g and g + 8 of the
//    accumulator layout each read a quarter of those rows of O and dO
//    with 16-byte loads, sum in f32 and add across the four by shuffles,
//    and one of them writes the rows' delta. Per kv tile, S = Q.K^T and
//    dP = dO.V^T are wgmma products with both operands in shared memory,
//    issued together and committed once; P = 2^(S scale log2e - lse
//    log2e) and dS = P (dP - delta) are formed in registers (masked only
//    on the diagonal or ragged tile), and dS, packed to bf16, is the A
//    operand of the wgmma dQ += dS.K, with K read as a transposed
//    (MN-major) B. The tensor cores read each K and V tile once per
//    warpgroup, where mma.sync had every warp load both through ldmatrix.
//    Under the causal mask the first warpgroup has no live key in the
//    block's last kv tile; it skips that tile's products but still waits
//    for the tile and releases the slot, so the ring's phases stay whole.
//    setmaxnreg moves registers from the producer warpgroup (24) to the
//    consumers (240).
//  - f32: CUDA-core FMAs in f32, four threads per query row, each owning a
//    quarter of the head dims, key by key over tiles of 32 keys; the four
//    also sum delta for their row.
// Tried and not kept (PERF.md): forming the next tile's dS while this
// tile's dS.K runs (the next S and dP issued first, a second dS buffer in
// registers), where ptxas serialised the wgmma pipeline (C7512) and the
// kernel ran slower; and a third ring slot, which measured within noise.
// Left for later: persistent blocks, fp8.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- bf16 --

constexpr int kBQ = 128;       // query rows per block, 64 per consumer
constexpr int kBK = 64;        // keys per kv tile
constexpr int kStages = 2;     // K/V ring slots
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreadsBf16 = (kConsumers + 1) * 128;

// Dynamic shared memory of the bf16 kernel, byte offsets from a 1024-byte
// aligned base: the Q and dO tiles, kStages K tiles and kStages V tiles
// (each D / 64 panels of [rows][64] bf16), then the mbarriers: qdo_full,
// and full and empty per slot.
template <int D>
struct DqSmem {
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// This thread's quarter of sum_d x[d] y[d] over one bf16 row of D: the
// 16-byte chunks t, t + 4, ..., so the four threads t = 0..3 of a quad
// read 64 neighbouring bytes at a time. Products of bf16 are exact in f32.
template <int D>
__device__ __forceinline__ float quarter_dot(const __nv_bfloat16* x,
                                             const __nv_bfloat16* y, int t) {
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const int c = (t + 4 * i) * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(x + c);
    const uint4 w = *reinterpret_cast<const uint4*>(y + c);
    const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fa = __bfloat1622float2(ap[j]);
      const float2 fw = __bfloat1622float2(wp[j]);
      sum = fmaf(fa.x, fw.x, sum);
      sum = fmaf(fa.y, fw.y, sum);
    }
  }
  return sum;
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
fa_dq_bf16(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tdo,
           const __nv_bfloat16* __restrict__ o,
           const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dq, int S, int Hq, int Hkv,
           Strides so, Strides sdo, Strides sdq, float scale, int causal) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base_1024(smem_raw);
  const uint32_t q_s = base, do_s = base + L::kDO;
  const uint32_t k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t qdo_full = base + L::kBar;
  const uint32_t full = qdo_full + 8;          // [kStages]
  const uint32_t empty = full + 8 * kStages;   // [kStages]

  const int tid = threadIdx.x, wg = warpgroup_index();
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread keeps the ring full; a slot is refilled once
    // every consumer thread has released it.
    setmaxnreg_dec<24>();
    if (tid == kConsumers * 128) {
      mbar_arrive_expect_tx(qdo_full, 2 * L::kQBytes);
      for (int p = 0; p < D / 64; ++p) {
        tma_load_4d(q_s + p * kBQ * 128, &tq, qdo_full, p * 64, h, q0, b);
        tma_load_4d(do_s + p * kBQ * 128, &tdo, qdo_full, p * 64, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t ks = k_s + s * L::kKVBytes;
        const uint32_t vs = v_s + s * L::kKVBytes;
        mbar_arrive_expect_tx(full + 8 * s, 2 * L::kKVBytes);
        for (int p = 0; p < D / 64; ++p) {
          tma_load_4d(ks + p * kBK * 128, &tk, full + 8 * s, p * 64, kvh,
                      it * kBK, b);
          tma_load_4d(vs + p * kBK * 128, &tv, full + 8 * s, p * 64, kvh,
                      it * kBK, b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows row0 .. row0 + 63.
    setmaxnreg_inc<240>();
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;  // accumulator row, column pair
    const int row0 = q0 + wg * 64;
    // Rows g and g + 8 of this warp's 16: the rows of its accumulators.
    const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;

    // delta = rowsum(dO * O) of rows r0 and r1, summed over the quad.
    const __nv_bfloat16* ob = o + b * so.b + h * so.h;
    const __nv_bfloat16* dob = dout + b * sdo.b + h * sdo.h;
    float dl0 = r0 < S ? quarter_dot<D>(ob + r0 * so.s, dob + r0 * sdo.s, t)
                       : 0.f;
    float dl1 = r1 < S ? quarter_dot<D>(ob + r1 * so.s, dob + r1 * sdo.s, t)
                       : 0.f;
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
    const long long rows = static_cast<long long>(bh) * S;
    if (t == 0) {
      if (r0 < S) delta[rows + r0] = dl0;
      if (r1 < S) delta[rows + r1] = dl1;
    }
    // The rows' logsumexp in log2 units.
    const float lse0 = r0 < S ? lse[rows + r0] * kLog2e : 0.f;
    const float lse1 = r1 < S ? lse[rows + r1] * kLog2e : 0.f;
    const float sl2 = scale * kLog2e;
    const uint32_t qa = q_s + wg * 64 * 128;  // this warpgroup's Q rows
    const uint32_t da = do_s + wg * 64 * 128;  // and dO rows

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(qdo_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = it * kBK;
      // Waiting for the tile even when skipping it keeps this warpgroup's
      // release of slot s in the phase that loaded it.
      mbar_wait(full + 8 * s, ph);
      if (causal && k0 > row0 + 63) {  // no live key for these rows
        mbar_arrive(empty + 8 * s);
        continue;
      }
      const uint32_t ks = k_s + s * L::kKVBytes;
      const uint32_t vs = v_s + s * L::kKVBytes;

      // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows and the
      // tile's 64 keys: a k16 step moves 32 bytes along the swizzled rows,
      // four steps a panel.
      float sc[kBK / 2], dp[kBK / 2];
      const uint64_t qd = opaque(sw128_desc(qa, 16, 1024));
      const uint64_t kd = opaque(sw128_desc(ks, 16, 1024));
      const uint64_t dod = opaque(sw128_desc(da, 16, 1024));
      const uint64_t vd = opaque(sw128_desc(vs, 16, 1024));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<kBK, 0>(sc, desc_add(qd, (kk / 4) * kBQ * 128 + off),
                         desc_add(kd, (kk / 4) * kBK * 128 + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<kBK, 0>(dp, desc_add(dod, (kk / 4) * kBQ * 128 + off),
                         desc_add(vd, (kk / 4) * kBK * 128 + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      reg_fence(dp);

      // P = 2^(S scale log2e - lse log2e), 0 where masked; dS = P (dP -
      // delta) overwrites dP. Only tiles on the diagonal or the ragged end
      // mask.
      const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > row0);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = exp2f(sc[4 * j + e] * sl2 - lse0);
          float p1 = exp2f(sc[4 * j + 2 + e] * sl2 - lse1);
          if (edge) {
            const int key = k0 + j * 8 + t * 2 + e;
            if (key >= S || (causal && key > r0)) p0 = 0.f;
            if (key >= S || (causal && key > r1)) p1 = 0.f;
          }
          dp[4 * j + e] = p0 * (dp[4 * j + e] - dl0);
          dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl1);
        }
      }

      // dQ += dS K: dS's accumulators, packed to bf16, are the A operands
      // of the tile's four k16 steps; K, read as a transposed B, has its
      // 16-row steps 2048 bytes apart and its 64-column panels kBK * 128
      // bytes.
      uint32_t dsa[kBK / 16][4];
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) acc_to_a(dsa[kc], dp, kc);
      const uint64_t kt = opaque(sw128_desc(ks, kBK * 128, 1024));
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc)
        wgmma_rs<D, 1>(acc, dsa[kc], desc_add(kt, kc * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      mbar_arrive(empty + 8 * s);  // this thread is done with slot s
    }

    __nv_bfloat16* out = dq + b * sdq.b + h * sdq.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = n * 8 + t * 2;
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(out + r0 * sdq.s + d) =
            pack_bf16(acc[4 * n] * scale, acc[4 * n + 1] * scale);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(out + r1 * sdq.s + d) =
            pack_bf16(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
    }
  }
}

// ----------------------------------------------------------------- f32 --

constexpr int kSBQ = 64;  // query rows per block, four threads per row
constexpr int kSBK = 32;  // keys per kv tile
constexpr int kThreadsF32 = 256;

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
fa_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, float* __restrict__ dq, int S, int Hq,
          int Hkv, Strides sq, Strides sk, Strides sv, Strides so,
          Strides sdo, Strides sdq, float scale, int causal) {
  constexpr int DT = D / 4;  // head dims per thread: d = 4 * j + part
  __shared__ float k_s[kSBK][D];
  __shared__ float v_s[kSBK][D];

  const int tid = threadIdx.x, part = tid & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kSBQ;
  const int r = q0 + (tid >> 2);
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const float* qb = q + b * sq.b + h * sq.h;
  const float* ob = o + b * so.b + h * so.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  // Q and dO of row r in registers, and delta = rowsum(dO * O), of which
  // the four threads of the row hold a quarter each.
  float qr[DT], dor[DT], acc[DT];
  float dl = 0.f;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    qr[j] = r < S ? qb[r * sq.s + 4 * j + part] : 0.f;
    dor[j] = r < S ? dob[r * sdo.s + 4 * j + part] : 0.f;
    dl = fmaf(dor[j], r < S ? ob[r * so.s + 4 * j + part] : 0.f, dl);
    acc[j] = 0.f;
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  const long long row = static_cast<long long>(bh) * S + r;
  if (r < S && part == 0) delta[row] = dl;
  const float lr = r < S ? lse[row] : 0.f;

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
cudaError_t launch_bf16(cudaStream_t st, const void* q, const void* k,
                        const void* v, const void* o, const void* dout,
                        const float* lse, float* delta, void* dq, int B,
                        int S, int Hq, int Hkv, Strides sq, Strides sk,
                        Strides sv, Strides so, Strides sdo, Strides sdq,
                        float scale, int causal) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bf16_tensor_map(&tq, q, B, S, Hq, D, sq, kBQ);
  if (err == cudaSuccess)
    err = bf16_tensor_map(&tk, k, B, S, Hkv, D, sk, kBK);
  if (err == cudaSuccess)
    err = bf16_tensor_map(&tv, v, B, S, Hkv, D, sv, kBK);
  if (err == cudaSuccess)
    err = bf16_tensor_map(&tdo, dout, B, S, Hq, D, sdo, kBQ);
  if (err != cudaSuccess) return err;
  constexpr int smem = DqSmem<D>::kBytes;
  // Above 48 KB needs the opt-in, which holds for the current device
  // only, so it is set on every launch.
  err = cudaFuncSetAttribute(
      fa_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  fa_dq_bf16<D><<<grid, kThreadsBf16, smem, st>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), S, Hq, Hkv, so, sdo, sdq, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, cudaStream_t st, const void* q, const void* k,
                   const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, int B, int S,
                   int Hq, int Hkv, Strides sq, Strides sk, Strides sv,
                   Strides so, Strides sdo, Strides sdq, float scale,
                   int causal) {
  if (dtype == 1)
    return launch_bf16<D>(st, q, k, v, o, dout, lse, delta, dq, B, S, Hq,
                          Hkv, sq, sk, sv, so, sdo, sdq, scale, causal);
  const dim3 grid((S + kSBQ - 1) / kSBQ, B * Hq);
  fa_dq_f32<D><<<grid, kThreadsF32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),
      S, Hq, Hkv, sq, sk, sv, so, sdo, sdq, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; lse (read)
// and delta (written) are contiguous (B, Hq, S) f32. Returns the
// cudaError_t of the tensor-map encode or the launch (0 on success); runs
// on `stream`, no sync.
extern "C" int fa_dq(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, int dtype, int B, int S, int Hq,
                     int Hkv, int D, long long sq_b, long long sq_s,
                     long long sq_h, long long sk_b, long long sk_s,
                     long long sk_h, long long sv_b, long long sv_s,
                     long long sv_h, long long so_b, long long so_s,
                     long long so_h, long long sdo_b, long long sdo_s,
                     long long sdo_h, long long sdq_b, long long sdq_s,
                     long long sdq_h, float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sq_b, sq_s, sq_h}, sk{sk_b, sk_s, sk_h},
      sv{sv_b, sv_s, sv_h}, so{so_b, so_s, so_h}, sdo{sdo_b, sdo_s, sdo_h},
      sdq{sdq_b, sdq_s, sdq_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (D == 64)
    return static_cast<int>(launch<64>(dtype, st, q, k, v, o, dout, l, dl,
                                       dq, B, S, Hq, Hkv, sq, sk, sv, so,
                                       sdo, sdq, scale, causal));
  if (D == 128)
    return static_cast<int>(launch<128>(dtype, st, q, k, v, o, dout, l, dl,
                                        dq, B, S, Hq, Hkv, sq, sk, sv, so,
                                        sdo, sdq, scale, causal));
  return static_cast<int>(cudaErrorInvalidValue);
}
