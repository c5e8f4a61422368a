// Flash-attention forward for Hopper (sm_90a): causal / non-causal GQA
// attention with an online softmax, read straight from the [B, S, H, hd]
// layout through strides.
//
// Replaces the TPU kernel `_flash_kernel`
// (k8s_dra_driver_gpu_tpu/ops/flash_attention.py:40-101), both its
// forward-only variant (pallas_call at :419, the serving path) and its
// with-lse variant (:428, the training path): same arithmetic, not the
// same blocking.
//   * scores = (q . k) in fp32, then * scale; masked scores are -1e30
//     (not -inf); running max m, normaliser l and the output accumulator
//     stay in fp32; p is rounded to the input type before the P.V product
//     while l sums the unrounded p; l is clamped at 1e-30;
//     lse = m + log(l), written only when its pointer is non-null.
//   * The bf16 kernel takes exp as 2^x on the SFU (ex2.approx) with
//     log2(e) folded into the scale: it keeps m in base-2 units (the max
//     of q.k * scale * log2 e), forms p = 2^(q.k * c - m) with one fma,
//     and writes lse = m * ln 2 + log(l). The change is an fp32 rounding
//     of the score and the SFU's ~2 ulp, far inside the card check's
//     tolerances.
//   * GQA by index: q-head h reads kv-head h / (H / K); K/V are never
//     repeated. Causal mode stops the k loop at the diagonal tile.
//   * Ragged S is masked in-kernel (rows past S land as zeros, keys past
//     S are masked); only rows < S of O and lse are written.
//
// Bound on an H100 SXM: 4*hd FLOP per unmasked (q, k) pair. At the
// serving shape (B=4, S=2048, H=32, K=8, hd=128, causal, bf16): ~137
// GFLOP over 989 TFLOP/s (bf16 dense) = 0.14 ms, against ~168 MB of
// Q/K/V/O over 3.35 TB/s = 0.05 ms. At the training
// shape (B=4, S=4096, H=16) 0.28 ms against 0.07 ms. Compute-bound: the
// tensor cores decide, and only wgmma reaches their full rate.
//
// Design of the bf16 kernel (it replaces a first version with mma.sync
// m16n8k16, 64-row tiles, 4 warps and loads staged by every thread between
// two __syncthreads, which ran at 13-14% of the bound):
//   * One block of three warpgroups per (b*h, 128-row q tile). Warpgroups
//     0 and 1 are consumers, 64 q rows each; warpgroup 2 is the producer.
//     The roles split in one if/else at the top, so setmaxnreg moves
//     registers from the producer (40) to the consumers (232).
//   * Loads are TMA boxes through tensor maps (4-D over hd, heads, S, B,
//     byte strides from the tensor's own, built by the wrapper), 64 bf16
//     wide with the 128-byte swizzle that wgmma reads without bank
//     conflicts; a 128-wide head is two boxes. TMA zero-fills rows past
//     S, so a masked key never brings NaN into P.V. One producer thread
//     loads Q once, then K and V tiles of 128 keys into a two-stage ring:
//     each K and each V has its own full barrier (Q.K^T starts before V
//     lands) and its own empty barrier that hands the slot back.
//     Shared memory at hd=128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB.
//   * S = Q.K^T is wgmma m64n128k16 with Q and K both K-major in shared
//     memory. Masking, the online softmax and the O rescale run in
//     registers on the accumulator fragment, which is re-packed as bf16
//     pairs into the register-A operand of O += P.V (m64n{hd}k16, V read
//     MN-major through the transpose flag): P never touches shared memory.
//   * The tensor cores are kept busy while the softmax runs on the ALUs
//     and the SFU. Inside a warpgroup, Q.K^T of tile j is issued with
//     P.V of tile j-1, and the softmax of tile j runs while that P.V
//     does. Between the two warpgroups, a ping-pong over two named
//     barriers orders the issues, so that one's softmax runs while the
//     other's products hold the tensor cores.
//   * Epilogue: O / l written from registers with the qpos < S guard.
//   * Grid x walks (b, h) and y walks q tiles from the last: the heaviest
//     causal tiles of every head start first and do not trail the grid.
// The fp32 kernel (`flash_fwd_f32`; it replaces a first version of scalar
// FMAs on 32x32 tiles staged by all threads, ~20% of the fp32 FMA bound)
// keeps the same arithmetic in fp32 (expf; p not rounded) and runs its
// products on the tensor cores in 3xTF32: each operand x = hi + lo, both
// tf32, and a.b ~ hi.hi + hi.lo + lo.hi, accurate to ~2^-21 of each
// product where plain TF32 would miss the fp32 tolerance. Bound at the
// training shape (B=4, S=4096, H=16, K=8, hd=128, causal): 3 TF32
// products of 4*hd FLOP a pair, 0.83 TFLOP at 495 TFLOP/s = 1.67 ms (the
// same work at the 67 TFLOP/s of fp32 FMA: 4.10 ms). Design: four warps a
// block own 64 q rows (16 a warp); 64-key K and V tiles come in by
// cp.async, V while S = Q.K^T runs and the next K while the softmax and
// P.V run, two blocks an SM; products are mma.sync m16n8k8 .tf32 (wgmma
// takes tf32 only K-major from shared memory, which P.V's V is not), the
// hi/lo split is made as a fragment is read (two integer ops and a
// subtraction a value), and fragments are laid out so that S's
// accumulator is P.V's A operand as it lies (see the kernel).
//
// The launch geometry (grid, threads, shared-memory bytes, tensor maps)
// is computed by the Python wrapper (ops/flash_attention.py, fwd_plan);
// the C entry checks it against the kernel's tiling before launching.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, S] fp32, or null
  int B, S, H, KH;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  float scale;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool key_valid(const Params& p, int kpos,
                                          int qpos) {
  return kpos < p.S && (!p.causal || kpos <= qpos);
}

// ---------------------------------------------------------------- bf16

constexpr int kBM = 128;        // q rows a block: two consumer warpgroups
constexpr int kBN = 128;        // keys a K/V tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kPanel = 64;      // bf16 columns of one 128-byte swizzled box
constexpr int kBf16Threads = 384;
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBarriers = 1 + 4 * kStages;  // Q; K/V full; K/V empty

template <int HD>
constexpr size_t bf16_smem_bytes() {
  // 1024 bytes of slack to align the tiles to the swizzle atom.
  return 1024 + sizeof(__nv_bfloat16) * (kBM * HD + 2 * kStages * kBN * HD) +
         8 * kBarriers;
}

template <int HD>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using namespace hopper;
  constexpr int kPanels = HD / kPanel;
  constexpr uint32_t kQBytes = kBM * HD * 2;   // one Q tile
  constexpr uint32_t kKVBytes = kBN * HD * 2;  // one K or V tile
  constexpr uint32_t kRowBytes = kPanel * 2;   // 128: a swizzled box row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + kQBytes;               // stage s: + s * kKVBytes
  const uint32_t sv = sk + kStages * kKVBytes;
  const uint32_t bars = sv + kStages * kKVBytes;  // 8 bytes each
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.KH);
  const int q_end = min(q0 + kBM, p.S);
  const int n_kt = p.causal ? (q_end + kBN - 1) / kBN : (p.S + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumers);
      mbar_init(v_empty(s), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every load.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < kPanels; ++c) {
        tma_load_4d(sq + c * kBM * kRowBytes, &tm_q, q_full, c * kPanel, h, q0,
                    b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        // The n-th fill of a slot waits for the (n-1)-th release.
        const uint32_t parity = ((kt / kStages) & 1) ^ 1;
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), kKVBytes);
        for (int c = 0; c < kPanels; ++c) {
          tma_load_4d(sk + s * kKVBytes + c * kBN * kRowBytes, &tm_k, k_full(s),
                      c * kPanel, kh, kt * kBN, b);
        }
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), kKVBytes);
        for (int c = 0; c < kPanels; ++c) {
          tma_load_4d(sv + s * kKVBytes + c * kBN * kRowBytes, &tm_v, v_full(s),
                      c * kPanel, kh, kt * kBN, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63.
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * wg;
    const int qpos[2] = {row0 + 16 * warp + g, row0 + 16 * warp + g + 8};
    const uint32_t sq_wg = sq + 64 * wg * kRowBytes;
    const float scale_log2 = p.scale * kLog2e;
    // Ping-pong: the two warpgroups take turns to issue their products
    // (named barrier 1 + wg is this warpgroup's turn), so that one's
    // softmax runs while the other's wgmma holds the tensor cores.
    const int my_turn = 1 + wg, other_turn = 2 - wg;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // base-2 units
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums
    float alpha[2];                   // O's rescale for the last softmax
    float sc[kBN / 2];                // scores, then p, of one K tile
    uint32_t pa[kBN / 16][4];         // p in bf16: P.V's register A

    // S = Q . K_kt^T, 64 rows x 128 keys in hd/16 steps; async.
    auto issue_qk = [&](int kt) {
      const int s = kt % kStages;
      mbar_wait(k_full(s), (kt / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
        const uint64_t da = desc_b128(
            sq_wg + (kk / 4) * kBM * kRowBytes + col, 16, 1024);
        const uint64_t db = desc_b128(
            sk + s * kKVBytes + (kk / 4) * kBN * kRowBytes + col, 16, 1024);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P . V_kt, 16 keys a step (V rows are K, its 128-byte rows N);
    // async.
    auto issue_pv = [&](int kt) {
      const int s = kt % kStages;
      mbar_wait(v_full(s), (kt / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t dv = desc_b128(sv + s * kKVBytes + kk * 16 * kRowBytes,
                                      kBN * kRowBytes, 1024);
        if constexpr (HD == 128) {
          wgmma_rs_n128(o, pa[kk], dv);
        } else {
          wgmma_rs_n64(o, pa[kk], dv);
        }
      }
      wgmma_commit();
    };
    // Mask (only the diagonal and ragged tiles need it), scale, fold the
    // tile into the running max and sum, and leave p (fp32) in sc.
    auto softmax = [&](int kt) {
      const int k0 = kt * kBN;
      const bool masked =
          k0 + kBN > p.S || (p.causal && k0 + kBN - 1 > row0);
      float mt[2] = {kNegInf, kNegInf};  // raw (unscaled) tile max
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (masked && !key_valid(p, k0 + 8 * j + 2 * t + (e & 1),
                                   qpos[e >> 1])) {
            sc[4 * j + e] = kNegInf;
          }
          mt[e >> 1] = fmaxf(mt[e >> 1], sc[4 * j + e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // scale > 0, so the max of the scaled scores is the scaled max.
        mt[r] = fmaxf(m[r], quad_max(mt[r]) * scale_log2);
        alpha[r] = ex2(m[r] - mt[r]);
        m[r] = mt[r];
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        sc[i] = ex2(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));
        ls[(i >> 1) & 1] += sc[i];
      }
      l[0] = l[0] * alpha[0] + ls[0];
      l[1] = l[1] * alpha[1] + ls[1];
    };
    // P as the register-A operand: the C fragments of key columns
    // 16kk..16kk+15, rounded to bf16.
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    if (wg == 1) named_arrive(other_turn, kConsumers);  // warpgroup 0 first
    mbar_wait(q_full, 0);
    named_sync(my_turn, kConsumers);
    issue_qk(0);
    named_arrive(other_turn, kConsumers);
    wgmma_wait<0>();
    fence_operands(sc);
    mbar_arrive(k_empty(0));
    softmax(0);
    pack_p();
    for (int kt = 1; kt < n_kt; ++kt) {
      // Q.K^T of this tile runs beside P.V of the last one, and the
      // softmax of this tile beside that P.V.
      named_sync(my_turn, kConsumers);
      issue_qk(kt);
      issue_pv(kt - 1);
      named_arrive(other_turn, kConsumers);
      wgmma_wait<1>();
      fence_operands(sc);
      mbar_arrive(k_empty(kt % kStages));
      softmax(kt);
      wgmma_wait<0>();
      fence_operands(o);
      mbar_arrive(v_empty((kt - 1) % kStages));
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p();
    }
    named_sync(my_turn, kConsumers);
    issue_pv(n_kt - 1);
    // Every sync on a turn meets one arrival: warpgroup 1 arrived once
    // before its first turn, so it skips the arrival after its last.
    if (wg == 0) named_arrive(other_turn, kConsumers);
    wgmma_wait<0>();
    fence_operands(o);
    mbar_arrive(v_empty((n_kt - 1) % kStages));

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l_safe = fmaxf(quad_sum(l[r]), 1e-30f);
      if (qpos[r] >= p.S) continue;
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                           qpos[r] * p.o_ss + h * p.o_sh + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / l_safe,
                                  o[4 * j + 2 * r + 1] / l_safe);
      }
      if (p.lse != nullptr && t == 0) {
        p.lse[static_cast<long long>(bh) * p.S + qpos[r]] =
            m[r] * kLn2 + logf(l_safe);
      }
    }
  }
}

// ---------------------------------------------------------------- fp32

constexpr int kThreads = 128;  // four warps, 16 q rows each
constexpr int kF32BM = 64;     // q rows a block
constexpr int kF32BN = 64;     // keys a K/V tile

// Shared-memory row strides in floats. Q and K are read as float4 at
// (row g, column 4t) by the eight lanes of a quarter-warp (g in {0, 1},
// t in 0..3): a stride = 16 (mod 32) puts them on eight distinct bank
// quads. V is read as single floats at (row 2t or 2t + 1, column g) by a
// whole warp: a stride = 4 (mod 32) puts the 32 lanes on 32 banks.
template <int HD>
__host__ __device__ constexpr int f32_qk_stride() {
  return HD + 16;
}
template <int HD>
__host__ __device__ constexpr int f32_v_stride() {
  return HD + 4;
}

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((kF32BM + kF32BN) * f32_qk_stride<HD>() +
                          kF32BN * f32_v_stride<HD>());
}

// Warp w owns q rows q0 + 16w .. + 15; lane (g, t) holds the rows g and
// g + 8 of its warp's fragments. Every product is 3xTF32 mma.sync
// m16n8k8 (hopper.cuh). Two permutations make the fragments fit without
// shuffles: in S = Q.K^T the depth index of k-step pair kp is permuted so
// that lane t reads columns 16kp + 4t .. + 3 of Q and K as one float4 (the
// first k-step takes the first two as its t and t + 4, the second the
// last two: a sum over d in another order); in O += P.V the depth (keys)
// of k-step j is permuted so that the A fragment's (t, t + 4) are keys
// 8j + 2t, 8j + 2t + 1, which is where S's accumulator already holds
// them: P feeds the product as it lies, and V's B fragment reads those
// two key rows.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_f32(const Params p) {
  using namespace hopper;
  constexpr int QS = f32_qk_stride<HD>(), VS = f32_v_stride<HD>();
  constexpr int BN = kF32BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kF32BM][QS]
  float* sK = sQ + kF32BM * QS;                    // [BN][QS]
  float* sV = sK + BN * QS;                        // [BN][VS]

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BM;  // heaviest first
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 16 * warp;
  const int qpos[2] = {row0 + g, row0 + g + 8};
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const int q_end = min(q0 + kF32BM, p.S);
  const int n_kt = ((p.causal ? q_end : p.S) + BN - 1) / BN;

  cp_async_rows<HD, kF32BM, QS, kThreads>(smem_u32(sQ), q, p.q_ss, q0, p.S);
  cp_async_rows<HD, BN, QS, kThreads>(smem_u32(sK), k, p.k_ss, 0, p.S);
  cp_async_commit();

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  const float* q_g = sQ + (16 * warp + g) * QS + 4 * t;
  const float* k_g = sK + g * QS + 4 * t;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    // V of this tile lands while S is computed.
    cp_async_rows<HD, BN, VS, kThreads>(smem_u32(sV), v, p.v_ss, k0, p.S);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this K tile
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < HD / 16; ++kp) {
      const float4 qa = *reinterpret_cast<const float4*>(q_g + 16 * kp);
      const float4 qb = *reinterpret_cast<const float4*>(q_g + 8 * QS + 16 * kp);
      const FragA a0 = split_a(qa.x, qb.x, qa.y, qb.y);
      const FragA a1 = split_a(qa.z, qb.z, qa.w, qb.w);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float4 kb =
            *reinterpret_cast<const float4*>(k_g + 8 * j * QS + 16 * kp);
        mma_3xtf32(s[j], a0, kb.x, kb.y);
        mma_3xtf32(s[j], a1, kb.z, kb.w);
      }
    }
    __syncthreads();  // every warp has read this K tile
    // The next K tile lands while the softmax and P.V run.
    if (kt + 1 < n_kt) {
      cp_async_rows<HD, BN, QS, kThreads>(smem_u32(sK), k, p.k_ss, k0 + BN,
                                          p.S);
    }
    cp_async_commit();

    // Scale, mask (only the diagonal and ragged tiles need it), and fold
    // the tile into the running max and sum; s becomes p.
    const bool masked = k0 + BN > p.S || (p.causal && k0 + BN - 1 > row0);
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (masked && !key_valid(p, k0 + 8 * j + 2 * t + (e & 1),
                                 qpos[e >> 1])) {
          x = kNegInf;
        }
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mt[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        ls[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    }

    cp_async_wait<1>();  // this V tile
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const FragA a = split_a(s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* v_t = sV + (8 * j + 2 * t) * VS + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        mma_3xtf32(o[n], a, v_t[8 * n], v_t[VS + 8 * n]);
      }
    }
    __syncthreads();  // every warp has read this V tile
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = fmaxf(quad_sum(l[r]), 1e-30f);
    if (qpos[r] >= p.S) continue;
    float* out = static_cast<float*>(p.o) + b * p.o_sb + qpos[r] * p.o_ss +
                 h * p.o_sh + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(o[n][2 * r] / l_safe, o[n][2 * r + 1] / l_safe);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[static_cast<long long>(bh) * p.S + qpos[r]] = m[r] + logf(l_safe);
    }
  }
}

// The wrapper's launch geometry: grid x, grid y, threads, shared-memory
// bytes, then (bf16) three tensor maps of 12 values each, for q, k, v:
// dims[4] (hd, heads, S, B), byte strides[3], box[4], swizzle bytes.
constexpr int kGeomHead = 4;
constexpr int kMapLen = 12;

bool grid_ok(const Params& p, const long long* g, int block_m, int threads,
             size_t smem) {
  return g[0] == static_cast<long long>(p.B) * p.H &&
         g[1] == (p.S + block_m - 1) / block_m && g[2] == threads &&
         g[3] >= static_cast<long long>(smem) && g[3] <= 232448;
}

template <int HD>
int launch_bf16(const Params& p, const long long* g, cudaStream_t stream) {
  const long long* mq = g + kGeomHead;
  const long long* mk = mq + kMapLen;
  const long long* mv = mk + kMapLen;
  // The kernel's barrier byte counts follow from its tiling: a geometry
  // that disagrees would leave a wait that never completes.
  if (!grid_ok(p, g, kBM, kBf16Threads, bf16_smem_bytes<HD>()) ||
      !hopper::bf16_map_ok(mq, HD, p.H, p.S, p.B, kBM) ||
      !hopper::bf16_map_ok(mk, HD, p.KH, p.S, p.B, kBN) ||
      !hopper::bf16_map_ok(mv, HD, p.KH, p.S, p.B, kBN)) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap tq, tk, tv;
  int err = hopper::encode_bf16_map(&tq, p.q, mq);
  if (err == 0) err = hopper::encode_bf16_map(&tk, p.k, mk);
  if (err == 0) err = hopper::encode_bf16_map(&tv, p.v, mv);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g[3]));
  if (attr != cudaSuccess) return attr;
  flash_fwd_bf16<HD><<<dim3(g[0], g[1]), g[2], g[3], stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int HD>
int launch_f32(const Params& p, const long long* g, cudaStream_t stream) {
  if (!grid_ok(p, g, kF32BM, kThreads, f32_smem_bytes<HD>())) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g[3]));
  if (attr != cudaSuccess) return attr;
  // All of the SM's unified cache as shared memory: two blocks an SM.
  const cudaError_t carve = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return carve;
  flash_fwd_f32<HD><<<dim3(g[0], g[1]), g[2], g[3], stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes. Strides are in elements; the last dim
// of every tensor is contiguous. dtype: 0 = fp32, 1 = bf16. `geometry` is
// the wrapper's launch plan (see above). Returns 0 on success, else a
// cudaError_t or hopper::kTensorMapError + CUresult.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int dtype, int B, int S, int H,
                         int KH, int hd, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_ss,
                         long long k_sh, long long v_sb, long long v_ss,
                         long long v_sh, long long o_sb, long long o_ss,
                         long long o_sh, const long long* geometry, int causal,
                         float scale, void* stream) {
  const Params p{q,    k,    v,    o,    static_cast<float*>(lse),
                 B,    S,    H,    KH,   q_sb,
                 q_ss, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, o_sb, o_ss,
                 o_sh, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hd == 128) return launch_bf16<128>(p, geometry, st);
  if (dtype == 1 && hd == 64) return launch_bf16<64>(p, geometry, st);
  if (dtype == 0 && hd == 128) return launch_f32<128>(p, geometry, st);
  if (dtype == 0 && hd == 64) return launch_f32<64>(p, geometry, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_error_string(int err) {
  return hopper::error_string(err);
}
