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
// blocks of a grid run in no order, so one block owns a query tile of one
// head and loops over the kv tiles itself, with m, l and acc in registers.
// Blocks are launched longest-causal-row first so the diagonal's short
// tiles fill the tail of the grid.
//  - bf16: a 128-row query tile per block, warp-specialised. One producer
//    thread issues TMA (hopper.cuh): the Q tile once, then 128-key K and V
//    tiles into a two-stage ring whose slots are guarded by full and empty
//    mbarriers; TMA swizzles the tiles for wgmma and zero-fills rows past
//    S. Two consumer warpgroups own 64 query rows each. S = Q.K^T is a
//    wgmma with both operands in shared memory; the online softmax runs in
//    registers in base 2 (scores scaled by log2 e, the same function); P,
//    packed to bf16 in registers, is the A operand of the wgmma O += P.V,
//    with V read from shared memory as a transposed (MN-major) B. The
//    tensor cores read K and V once per warpgroup and tile, where
//    mma.sync had every warp load both tiles into registers. setmaxnreg
//    moves registers from the producer warpgroup (24) to the consumers
//    (240).
//  - f32: CUDA-core FMAs in f32 throughout (tensor cores would round the
//    inputs to tf32 or bf16), four threads per query row, each owning a
//    quarter of the head dims.
// Tried and not kept, as the two warpgroups already interleave on their
// own (PERF.md): the next tile's Q.K^T issued under this tile's softmax,
// and ping-pong named barriers between the warpgroups; each gained a few
// percent at most. Left for later: persistent blocks scheduled longest
// first, o written through TMA, fp8.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- bf16 --

constexpr int kBQ = 128;       // query rows per block, 64 per consumer
constexpr int kBK = 128;       // keys per kv tile
constexpr int kStages = 2;     // K/V ring slots
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreadsBf16 = (kConsumers + 1) * 128;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory of the bf16 kernel, byte offsets from a 1024-byte
// aligned base: the Q tile, kStages K tiles and kStages V tiles (each D / 64
// panels of [rows][64] bf16), then the mbarriers: q_full, and k_full,
// v_full and empty per slot.
template <int D>
struct FwdSmem {
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
fa_fwd_bf16(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
            int Hq, int Hkv, Strides so, float scale, int causal) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base_1024(smem_raw);
  const uint32_t q_s = base, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;             // [kStages]
  const uint32_t v_full = k_full + 8 * kStages;   // [kStages]
  const uint32_t empty = v_full + 8 * kStages;    // [kStages]

  const int tid = threadIdx.x, wg = warpgroup_index();
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
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
      mbar_arrive_expect_tx(q_full, L::kQBytes);
      for (int p = 0; p < D / 64; ++p)
        tma_load_4d(q_s + p * kBQ * 128, &tq, q_full, p * 64, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t ks = k_s + s * L::kKVBytes;
        const uint32_t vs = v_s + s * L::kKVBytes;
        mbar_arrive_expect_tx(k_full + 8 * s, L::kKVBytes);
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(ks + p * kBK * 128, &tk, k_full + 8 * s, p * 64, kvh,
                      it * kBK, b);
        mbar_arrive_expect_tx(v_full + 8 * s, L::kKVBytes);
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(vs + p * kBK * 128, &tv, v_full + 8 * s, p * 64, kvh,
                      it * kBK, b);
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
    const uint32_t qa = q_s + wg * 64 * 128;  // this warpgroup's Q rows

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // Running max of rows r0, r1 in log2 units (p = 2^(s*scale*log2e - m)),
    // and this thread's share of their running sums.
    float m0 = kMaskFill, m1 = kMaskFill, l0 = 0.f, l1 = 0.f;
    const float sl2 = scale * kLog2e;
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = it * kBK;
      const uint32_t ks = k_s + s * L::kKVBytes;
      const uint32_t vs = v_s + s * L::kKVBytes;

      // S = Q K^T for this warpgroup's 64 rows and the tile's 128 keys: a
      // k16 step moves 32 bytes along the swizzled rows, four steps a panel.
      float sc[kBK / 2];
      const uint64_t qd = opaque(sw128_desc(qa, 16, 1024));
      const uint64_t kd = opaque(sw128_desc(ks, 16, 1024));
      mbar_wait(k_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<kBK, 0>(sc, desc_add(qd, (kk / 4) * kBQ * 128 + off),
                         desc_add(kd, (kk / 4) * kBK * 128 + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);

      // Only tiles on the diagonal or the ragged end need the mask.
      const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > row0);
      float mx0 = kMaskFill, mx1 = kMaskFill;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = sc[4 * j + e] * sl2, c = sc[4 * j + 2 + e] * sl2;
          if (edge) {
            const int key = k0 + j * 8 + t * 2 + e;
            if (key >= S || (causal && key > r0)) a = kMaskFill;
            if (key >= S || (causal && key > r1)) c = kMaskFill;
          }
          sc[4 * j + e] = a;
          sc[4 * j + 2 + e] = c;
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
        sc[4 * j] = exp2f(sc[4 * j] - mn0);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn1);
        ps0 += sc[4 * j] + sc[4 * j + 1];
        ps1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= al0;
        acc[4 * n + 1] *= al0;
        acc[4 * n + 2] *= al1;
        acc[4 * n + 3] *= al1;
      }

      // O += P V: P's accumulators, packed to bf16, are the A operands of
      // the tile's eight k16 steps; V's 16-row steps are 2048 bytes apart
      // and its 64-column panels kBK * 128 bytes.
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) acc_to_a(pa[kc], sc, kc);
      const uint64_t vd = opaque(sw128_desc(vs, kBK * 128, 1024));
      mbar_wait(v_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc)
        wgmma_rs<D, 1>(acc, pa[kc], desc_add(vd, kc * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      mbar_arrive(empty + 8 * s);  // this thread is done with slot s
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    const float inv0 = 1.f / den0, inv1 = 1.f / den1;
    __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = n * 8 + t * 2;
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(ob + r0 * so.s + d) =
            pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(ob + r1 * so.s + d) =
            pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
    }
    if (t == 0) {
      float* lb = lse + static_cast<long long>(bh) * S;
      if (r0 < S) lb[r0] = m0 * kLn2 + logf(den0);
      if (r1 < S) lb[r1] = m1 * kLn2 + logf(den1);
    }
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
cudaError_t launch_bf16(cudaStream_t st, const void* q, const void* k,
                        const void* v, void* o, float* lse, int B, int S,
                        int Hq, int Hkv, Strides sq, Strides sk, Strides sv,
                        Strides so, float scale, int causal) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = bf16_tensor_map(&tq, q, B, S, Hq, D, sq, kBQ);
  if (err == cudaSuccess)
    err = bf16_tensor_map(&tk, k, B, S, Hkv, D, sk, kBK);
  if (err == cudaSuccess)
    err = bf16_tensor_map(&tv, v, B, S, Hkv, D, sv, kBK);
  if (err != cudaSuccess) return err;
  constexpr int smem = FwdSmem<D>::kBytes;
  // Above 48 KB needs the opt-in, which holds for the current device
  // only, so it is set on every launch.
  err = cudaFuncSetAttribute(
      fa_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  fa_fwd_bf16<D><<<grid, kThreadsBf16, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, Hq, Hkv, so, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, cudaStream_t st, const void* q, const void* k,
                   const void* v, void* o, float* lse, int B, int S, int Hq,
                   int Hkv, Strides sq, Strides sk, Strides sv, Strides so,
                   float scale, int causal) {
  if (dtype == 1)
    return launch_bf16<D>(st, q, k, v, o, lse, B, S, Hq, Hkv, sq, sk, sv, so,
                          scale, causal);
  const dim3 grid((S + kSBQ - 1) / kSBQ, B * Hq);
  fa_fwd_f32<D><<<grid, kThreadsF32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Hq, Hkv,
      sq, sk, sv, so, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the tensor-map encode or the launch (0 on success); runs
// on `stream`, no sync.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D == 64)
    return static_cast<int>(launch<64>(dtype, st, q, k, v, o, l, B, S, Hq,
                                       Hkv, sq, sk, sv, so, scale, causal));
  if (D == 128)
    return static_cast<int>(launch<128>(dtype, st, q, k, v, o, l, B, S, Hq,
                                        Hkv, sq, sk, sv, so, scale, causal));
  return static_cast<int>(cudaErrorInvalidValue);
}
