// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV of causal /
// non-causal GQA attention, rebuilt from the forward's logsumexp, read
// straight from the [B, S, H, hd] / [B, S, K, hd] layout through TMA
// tensor maps.
//
// Replaces the TPU kernels
//   * `_flash_dq_kernel` (k8s_dra_driver_gpu_tpu/ops/flash_attention.py:104,
//     pallas_call at :512) with `flash_bwd_dq_bf16` and `flash_bwd_dq_f32`,
//     and
//   * `_flash_dkv_kernel` (:157, pallas_call at :536) with
//     `flash_bwd_dkv_bf16` and `flash_bwd_dkv_f32`.
// Same arithmetic and the same casts:
//   s  = (q . k) in fp32, * scale; masked entries give p = 0 (the TPU kernel
//        masks s to -1e30, whose exp(s - lse) is 0);
//   p  = exp(s - lse)                 (fp32)
//   dp = dO . v                       (bf16 in, fp32 accumulate)
//   ds = p * (dp - D), D = rowsum(dO * O) in fp32, computed by the caller
//   dQ = scale * sum_k bf16(ds) . k, written in q's dtype
//   dV = sum_q bf16(p)^T . dO,  dK = scale * sum_q bf16(ds)^T . q,
//        written in k/v's dtype.
// exp is 2^x on the SFU (ex2.approx) with log2(e) folded into the scale and
// into lse: p = 2^(s_raw * scale * log2 e - lse * log2 e), one fma. The
// change is an fp32 rounding of the exponent and the SFU's ~2 ulp.
// GQA by index: q-head h reads kv-head h / (H / K). The TPU version writes
// per-q-head fp32 dK/dV partials [B*H, S_pad, hd] and sums each group
// outside the kernel; here one block owns a kv-head's key tile and loops
// over the group's q-heads, so the group sum stays in fp32 registers and
// never makes an fp32 round trip through device memory. No atomics: each
// output element is written by one thread, so runs are deterministic.
// Ragged S is masked in-kernel: TMA lands rows past S as zeros, masked
// pairs give p = 0, and only rows < S are written. No padding copies.
//
// Bound on an H100 SXM at the training shape (B=4, S=4096, H=16, K=8,
// hd=128, causal, bf16), over the S(S+1)/2 unmasked pairs of every (b, h):
//   dQ:    3 products (Q.K^T, dO.V^T, dS.K)       = 6*hd FLOP a pair,
//          0.41 TFLOP at 989 TFLOP/s = 0.42 ms; ~0.27 GB read/written at
//          3.35 TB/s = 0.08 ms;
//   dK/dV: 4 products (K.Q^T, V.dO^T, P^T.dO, dS^T.Q) = 8*hd FLOP a pair,
//          0.55 TFLOP = 0.56 ms; ~0.27 GB = 0.08 ms.
// Both compute-bound: the tensor cores decide, and only wgmma reaches
// their full rate.
//
// Design:
//   * Both kernels: one block of three warpgroups. Warpgroups 0 and 1 are
//     consumers that own 64 rows of the block's 128-row tile each;
//     warpgroup 2 is the producer. The roles split in one if/else at the
//     top, so setmaxnreg moves registers from the producer (24) to the
//     consumers (240). All loads are TMA boxes of 64 rows by 64 bf16
//     (128 bytes, the 128-byte swizzle) through 4-D tensor maps over
//     (hd, heads, S, B) built by the wrapper; a 128-row tile is two boxes,
//     a 128-wide head two panels.
//   * Every product is wgmma. Products whose depth is hd read both
//     operands K-major from shared memory (m64n64k16): S = Q.K^T and
//     dP = dO.V^T in dQ, S^T = K.Q^T and dP^T = V.dO^T in dK/dV. Products
//     whose depth is keys or q rows take P or dS from registers (the
//     accumulator fragment re-packed as bf16 pairs) and read the other
//     operand MN-major from the same swizzled tile through the transpose
//     flag (m64n{hd}k16): dQ += dS.K; dV += P^T.dO and dK += dS^T.Q.
//     Nothing is transposed in memory, and P and dS never touch shared
//     memory.
//   * The softmax runs on the accumulator in registers with one fma and
//     one ex2 an element; only the causal diagonal tiles and the ragged
//     last tile evaluate the mask.
//   * dK/dV: a block owns (b, kv-head, 128-key tile). The producer loads
//     the K and V tiles once, then, for each q-head of the GQA group,
//     streams 64-row Q and dO tiles (from the diagonal tile on when
//     causal) through a three-stage ring with a full and an empty mbarrier
//     a slot. One producer warp also stages each tile's lse (times log2 e)
//     and D, [B, H, S] fp32, into the slot with plain loads (zeros past S):
//     a TMA map over them would need S * 4 bytes to be a multiple of 16.
//     Its 32 arrivals, one of them the TMA's expect_tx, complete the
//     slot's full barrier. Keys are the accumulator rows of S^T, so dK and
//     dV build up in registers with no transpose. The two consumer
//     warpgroups take turns to issue their products (a ping-pong over two
//     named barriers), so one's softmax runs while the other's products
//     hold the tensor cores. Grid y walks key tiles from the first, the
//     heaviest under the causal mask.
//   * dQ: a block owns (b, q-head, 128-row q tile). The producer loads Q
//     and dO once, then K and V tiles of 64 keys (up to the diagonal when
//     causal) into a three-stage ring, with a full and an empty barrier
//     for each K and each V slot. Each consumer thread reads lse and D of
//     its two rows once into registers. Inside a warpgroup, dQ += dS.K of
//     one tile runs beside S and dP of the next, whose softmax runs beside
//     them (no ping-pong: it made this kernel slower). Grid y walks q
//     tiles from the last, the heaviest.
//   * Shared memory at hd=128: dK/dV 2 x 32 KB (K, V) + 3 x (16 + 16 KB)
//     (Q, dO) + 1.5 KB (lse, D) = 161.5 KB; dQ 2 x 32 KB (Q, dO) + 3 x
//     (16 + 16 KB) (K, V) = 160 KB.
//
// fp32 (`flash_bwd_dq_f32`, `flash_bwd_dkv_f32`): the same arithmetic as
// above with expf and no rounding between steps, every product on the
// tensor cores in 3xTF32 (hopper.cuh: each operand split into two TF32
// values, three mma.sync m16n8k8), with cp.async tiles and two blocks an
// SM. Each kernel's design is described above it. Both replace scalar-FMA
// forms that ran at ~20% of their FMA bound. Bounds at the training shape:
// 3 TF32 products of 6*hd (dQ) and 8*hd (dK/dV) FLOP a pair at 495
// TFLOP/s, 2.50 ms and 3.33 ms (6.16 ms and 8.21 ms at the 67 TFLOP/s of
// fp32 FMA).
//
// The launch geometry (grids, threads, shared-memory bytes, tensor maps)
// is computed by the Python wrapper (ops/flash_attention.py, bwd_plan);
// the C entries check it against the kernels' tiling before launching.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 384;    // two consumer warpgroups and a producer
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kPanel = 64;       // bf16 columns of one 128-byte swizzled box
constexpr uint32_t kRowBytes = 128;
constexpr int kBoxRows = 64;     // rows of every TMA box
constexpr int kStages = 3;       // ring depth of both kernels
constexpr int kDqBM = 128;       // q rows of a dQ block
constexpr int kDqBN = 64;        // keys of a K/V tile in the dQ loop
constexpr int kDkvBN = 128;      // keys of a dK/dV block
constexpr int kDkvBM = 64;       // q rows of a Q/dO tile in the dK/dV loop

struct Params {
  const float* lse;   // [B, H, S] fp32
  const float* dsum;  // [B, H, S] fp32: rowsum(dO * O)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, S, H, KH;
  // Element strides of dims (b, s, head) of dq, dk, dv.
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int causal;
  float scale;
};

template <int HD>
constexpr size_t dq_smem_bytes() {
  // 1024 bytes of slack align the tiles to the swizzle atom; Q and dO,
  // then the K and V ring; barriers: Q/dO, K/V full, K/V empty.
  return 1024 + 2 * (2 * kDqBM * HD + 2 * kStages * kDqBN * HD) +
         8 * (1 + 4 * kStages);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  // Slack; K and V, then the Q and dO ring and each slot's lse and D;
  // barriers: K/V, slot full, slot empty.
  return 1024 + 2 * (2 * kDkvBN * HD + 2 * kStages * kDkvBM * HD) +
         4 * 2 * kStages * kDkvBM + 8 * (1 + 2 * kStages);
}

// P^T or dS^T of one 16-wide slice of the accumulator's columns as the
// register-A operand: the C fragments of columns 16kk..16kk+15 in bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[kk][i] = hopper::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
    }
  }
}

// Both kernels multiply the 64 rows of a 128-row tile that a consumer
// warpgroup owns (A) with a 64-row tile of the ring (B), or registers
// with such a tile. Tiles are rows of 128-byte swizzled panels, 64
// columns each; a panel of an R-row tile is R * 128 bytes.
static_assert(kDqBM == 128 && kDkvBN == 128 && kDqBN == 64 && kDkvBM == 64,
              "the product helpers below assume 128- and 64-row tiles");

// D (64 x 64) = A (64 rows x hd) . B (64 rows x hd)^T in hd/16 steps,
// both K-major; `a` is the warpgroup's first row of a 128-row tile, `b`
// a 64-row tile. Async, committed as one group.
template <int HD>
__device__ __forceinline__ void wgmma_rows_nt(float (&d)[32], uint32_t a,
                                              uint32_t b) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
    const uint64_t da =
        desc_b128(a + (kk / 4) * 128 * kRowBytes + col, 16, 1024);
    const uint64_t db =
        desc_b128(b + (kk / 4) * 64 * kRowBytes + col, 16, 1024);
    wgmma_ss_n64(d, da, db, kk > 0);
  }
  wgmma_commit();
}

// D (64 x hd) += A (64 x 64, registers, 16 columns a step) . B, a 64-row
// tile read MN-major (its rows are the depth, its 128-byte rows N). Async,
// not committed.
template <int HD>
__device__ __forceinline__ void wgmma_regs_tile(float (&d)[HD / 2],
                                                const uint32_t (&a)[4][4],
                                                uint32_t b) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db =
        desc_b128(b + kk * 16 * kRowBytes, 64 * kRowBytes, 1024);
    if constexpr (HD == 128) {
      wgmma_rs_n128(d, a[kk], db);
    } else {
      wgmma_rs_n64(d, a[kk], db);
    }
  }
}

// --------------------------------------------------------------- dK/dV

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const Params p) {
  using namespace hopper;
  constexpr int kPanels = HD / kPanel;
  constexpr uint32_t kKVBytes = kDkvBN * HD * 2;  // the K or the V tile
  constexpr uint32_t kQBytes = kDkvBM * HD * 2;   // one Q or dO tile
  constexpr int kRowFloats = 2 * kDkvBM;          // a slot's lse and D
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;
  const uint32_t sv = sk + kKVBytes;
  const uint32_t sq = sv + kKVBytes;              // slot s: + s * kQBytes
  const uint32_t sdo = sq + kStages * kQBytes;
  const uint32_t srows = sdo + kStages * kQBytes;
  const uint32_t bars = srows + 4 * kStages * kRowFloats;
  float* rows = reinterpret_cast<float*>(smem_raw + (srows - raw));
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

  const int k0 = blockIdx.y * kDkvBN;
  const int bk = blockIdx.x;
  const int b = bk / p.KH, kh = bk % p.KH;
  const int group = p.H / p.KH;
  // Causal: q tiles wholly above the diagonal see none of these keys.
  const int first_qt = p.causal ? k0 / kDkvBM : 0;
  const int n_qt = (p.S + kDkvBM - 1) / kDkvBM - first_qt;  // a q-head
  const int n_it = group * n_qt;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes
      mbar_init(empty(s), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: warp 0 stages lse and D, its lane 0 issues the TMA.
    setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x - 2 * 128;
    if (lane < 32) {
      if (lane == 0) {
        // Boxes wholly past S are not loaded: their rows are keys whose
        // dK/dV rows are never written, and nothing else reads them.
        const int n_box = min(kDkvBN, p.S - k0 + kBoxRows - 1) / kBoxRows;
        mbar_expect_tx(kv_full, 2 * kPanels * n_box * kBoxRows * kRowBytes);
        for (int c = 0; c < kPanels; ++c) {
          for (int r = 0; r < n_box * kBoxRows; r += kBoxRows) {
            const uint32_t off = (c * kDkvBN + r) * kRowBytes;
            tma_load_4d(sk + off, &tm_k, kv_full, c * kPanel, kh, k0 + r, b);
            tma_load_4d(sv + off, &tm_v, kv_full, c * kPanel, kh, k0 + r, b);
          }
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int hq = kh * group + it / n_qt;
        const int q0 = (first_qt + it % n_qt) * kDkvBM;
        // The n-th fill of a slot waits for the (n-1)-th release.
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const long long row0 = (static_cast<long long>(b) * p.H + hq) * p.S;
        float* slot = rows + s * kRowFloats;
        for (int r = lane; r < kDkvBM; r += 32) {
          const bool in = q0 + r < p.S;
          slot[r] = in ? p.lse[row0 + q0 + r] * kLog2e : 0.f;
          slot[kDkvBM + r] = in ? p.dsum[row0 + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * kQBytes);
          for (int c = 0; c < kPanels; ++c) {
            const uint32_t off = s * kQBytes + c * kDkvBM * kRowBytes;
            tma_load_4d(sq + off, &tm_q, full(s), c * kPanel, hq, q0, b);
            tma_load_4d(sdo + off, &tm_do, full(s), c * kPanel, hq, q0, b);
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63.
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int key0 = k0 + 64 * wg;
    const int kpos[2] = {key0 + 16 * warp + g, key0 + 16 * warp + g + 8};
    const uint32_t sk_wg = sk + 64 * wg * kRowBytes;
    const uint32_t sv_wg = sv + 64 * wg * kRowBytes;
    const float scale_log2 = p.scale * kLog2e;
    // Ping-pong: the two warpgroups take turns to issue their products
    // (named barrier 1 + wg is this warpgroup's turn), so that one's
    // softmax runs while the other's wgmma holds the tensor cores.
    const int my_turn = 1 + wg, other_turn = 2 - wg;

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[32];        // S^T, then P^T: 64 keys x 64 q rows
    float dpt[32];       // dP^T, then dS^T
    uint32_t pa[4][4];   // bf16(P^T): dV's register A
    uint32_t sa[4][4];   // bf16(dS^T): dK's register A

    if (wg == 1) named_arrive(other_turn, kConsumers);  // warpgroup 0 first
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int q0 = (first_qt + it % n_qt) * kDkvBM;
      const float* slot = rows + s * kRowFloats;
      mbar_wait(full(s), (it / kStages) & 1);
      named_sync(my_turn, kConsumers);
      wgmma_rows_nt<HD>(st, sk_wg, sq + s * kQBytes);     // S^T = K.Q^T
      wgmma_rows_nt<HD>(dpt, sv_wg, sdo + s * kQBytes);   // dP^T = V.dO^T
      named_arrive(other_turn, kConsumers);
      // P^T runs on the SFU while V.dO^T holds the tensor cores.
      wgmma_wait<1>();
      fence_operands(st);
      const bool masked = q0 + kDkvBM > p.S || (p.causal && q0 < key0 + 63);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lse2 =
            *reinterpret_cast<const float2*>(slot + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = ex2(fmaf(st[4 * j + e], scale_log2,
                             -((e & 1) ? lse2.y : lse2.x)));
          if (masked) {
            const int qpos = q0 + 8 * j + 2 * t + (e & 1);
            if (qpos >= p.S || (p.causal && kpos[e >> 1] > qpos)) x = 0.f;
          }
          st[4 * j + e] = x;
        }
      }
      wgmma_wait<0>();
      fence_operands(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(
            slot + kDkvBM + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dpt[4 * j + e] =
              st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d.y : d.x));
        }
      }
      pack_a(pa, st);
      pack_a(sa, dpt);
      named_sync(my_turn, kConsumers);
      wgmma_fence();
      wgmma_regs_tile<HD>(dv, pa, sdo + s * kQBytes);   // dV += P^T.dO
      wgmma_regs_tile<HD>(dk, sa, sq + s * kQBytes);    // dK += dS^T.Q
      wgmma_commit();
      // Every sync on a turn meets one arrival: warpgroup 1 arrived once
      // before its first turn, so it skips the arrival after its last.
      if (wg == 0 || it + 1 < n_it) named_arrive(other_turn, kConsumers);
      wgmma_wait<0>();
      fence_operands(dv);
      fence_operands(dk);
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kpos[r] >= p.S) continue;
      bf16* dk_out =
          p.dk + b * p.dk_sb + kpos[r] * p.dk_ss + kh * p.dk_sh + 2 * t;
      bf16* dv_out =
          p.dv + b * p.dv_sb + kpos[r] * p.dv_ss + kh * p.dv_sh + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk_out + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j + 2 * r] * p.scale,
                                  dk[4 * j + 2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_out + 8 * j) =
            __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ dQ

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const Params p) {
  using namespace hopper;
  constexpr int kPanels = HD / kPanel;
  constexpr uint32_t kQBytes = kDqBM * HD * 2;   // the Q or the dO tile
  constexpr uint32_t kKVBytes = kDqBN * HD * 2;  // one K or V tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + kQBytes;
  const uint32_t sk = sdo + kQBytes;              // slot s: + s * kKVBytes
  const uint32_t sv = sk + kStages * kKVBytes;
  const uint32_t bars = sv + kStages * kKVBytes;  // 8 bytes each
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqBM;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.KH);
  const int q_end = min(q0 + kDqBM, p.S);
  const int n_kt = ((p.causal ? q_end : p.S) + kDqBN - 1) / kDqBN;
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
      // Boxes wholly past S are not loaded: their rows are q rows whose
      // dQ rows are never written, and nothing else reads them.
      const int n_box = min(kDqBM, p.S - q0 + kBoxRows - 1) / kBoxRows;
      mbar_expect_tx(q_full, 2 * kPanels * n_box * kBoxRows * kRowBytes);
      for (int c = 0; c < kPanels; ++c) {
        for (int r = 0; r < n_box * kBoxRows; r += kBoxRows) {
          const uint32_t off = (c * kDqBM + r) * kRowBytes;
          tma_load_4d(sq + off, &tm_q, q_full, c * kPanel, h, q0 + r, b);
          tma_load_4d(sdo + off, &tm_do, q_full, c * kPanel, h, q0 + r, b);
        }
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        // The n-th fill of a slot waits for the (n-1)-th release.
        const uint32_t parity = ((kt / kStages) & 1) ^ 1;
        const uint32_t off = s * kKVBytes;
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), kKVBytes);
        for (int c = 0; c < kPanels; ++c) {
          tma_load_4d(sk + off + c * kDqBN * kRowBytes, &tm_k, k_full(s),
                      c * kPanel, kh, kt * kDqBN, b);
        }
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), kKVBytes);
        for (int c = 0; c < kPanels; ++c) {
          tma_load_4d(sv + off + c * kDqBN * kRowBytes, &tm_v, v_full(s),
                      c * kPanel, kh, kt * kDqBN, b);
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
    const uint32_t sdo_wg = sdo + 64 * wg * kRowBytes;
    const float scale_log2 = p.scale * kLog2e;
    float lse2[2], dsum[2];  // lse in base-2 units; D
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long i = static_cast<long long>(bh) * p.S + qpos[r];
      lse2[r] = qpos[r] < p.S ? p.lse[i] * kLog2e : 0.f;
      dsum[r] = qpos[r] < p.S ? p.dsum[i] : 0.f;
    }

    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    float sc[32];        // S, then P, then dS: 64 q rows x 64 keys
    float dp[32];        // dP
    uint32_t da[4][4];   // bf16(dS): dQ's register A

    // S = Q.K_kt^T and dP = dO.V_kt^T, each once its tile has landed.
    auto issue_s = [&](int kt) {
      const int s = kt % kStages;
      mbar_wait(k_full(s), (kt / kStages) & 1);
      wgmma_rows_nt<HD>(sc, sq_wg, sk + s * kKVBytes);
    };
    auto issue_dp = [&](int kt) {
      const int s = kt % kStages;
      mbar_wait(v_full(s), (kt / kStages) & 1);
      wgmma_rows_nt<HD>(dp, sdo_wg, sv + s * kKVBytes);
    };
    // dQ += dS . K_kt.
    auto issue_dq = [&](int kt) {
      wgmma_fence();
      wgmma_regs_tile<HD>(dq, da, sk + (kt % kStages) * kKVBytes);
      wgmma_commit();
    };
    // P = 2^(s * scale * log2 e - lse * log2 e) in sc; masked pairs 0.
    auto softmax = [&](int kt) {
      const int k0 = kt * kDqBN;
      const bool masked =
          k0 + kDqBN > p.S || (p.causal && k0 + kDqBN - 1 > row0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float x = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
        if (masked) {
          const int kpos = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (kpos >= p.S || (p.causal && kpos > qpos[r])) x = 0.f;
        }
        sc[i] = x;
      }
    };
    // dS = P * (dP - D) in sc.
    auto grad_s = [&]() {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - dsum[(i >> 1) & 1];
    };

    mbar_wait(q_full, 0);
    issue_s(0);
    issue_dp(0);
    wgmma_wait<1>();
    fence_operands(sc);
    softmax(0);
    wgmma_wait<0>();
    fence_operands(dp);
    mbar_arrive(v_empty(0));
    grad_s();
    pack_a(da, sc);
    for (int kt = 1; kt < n_kt; ++kt) {
      // S and dP of this tile run beside dQ of the last one, and this
      // tile's softmax beside dP and that dQ.
      issue_s(kt);
      issue_dp(kt);
      issue_dq(kt - 1);
      wgmma_wait<2>();
      fence_operands(sc);
      softmax(kt);
      wgmma_wait<1>();
      fence_operands(dp);
      mbar_arrive(v_empty(kt % kStages));
      grad_s();
      wgmma_wait<0>();
      fence_operands(dq);
      mbar_arrive(k_empty((kt - 1) % kStages));
      pack_a(da, sc);
    }
    issue_dq(n_kt - 1);
    wgmma_wait<0>();
    fence_operands(dq);
    mbar_arrive(k_empty((n_kt - 1) % kStages));

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qpos[r] >= p.S) continue;
      bf16* out = p.dq + b * p.dq_sb + qpos[r] * p.dq_ss + h * p.dq_sh + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(dq[4 * j + 2 * r] * p.scale,
                                  dq[4 * j + 2 * r + 1] * p.scale);
      }
    }
  }
}


// ---------------------------------------------------------------- fp32

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;   // [B, H, S]
  const float* dsum;  // [B, H, S]
  float* dq;
  float* dk;
  float* dv;
  int B, S, H, KH;
  // Element strides of dims (b, s, head): inputs q, k, v, dO, then
  // outputs dq, dk, dv.
  long long in[4][3];
  long long out[3][3];
  int causal;
  float scale;
};

// acc (16 rows x N) += X (16 rows x D: accumulator fragments of an
// earlier product, as they lie; the rows are those of its accumulator) . Y
// (D rows x N, shared, rows of RS floats; `y_t` at row 2t, column g of the
// lane), 3xTF32. The A columns t and t + 4 of k-step i are Y's rows
// 8i + 2t and 8i + 2t + 1, where the accumulator holds them. The
// products of two k-steps (16 depth rows) are summed from zero on the
// tensor cores, an n-tile at a time, and each sum is added to acc in fp32:
// one accumulator chain over every q row (3 * 8192 / 8 products at the
// training shape) drifted to ~1e-4 of dV, past the fp32 tolerance, where
// fp32 adds of the same products stay near 1e-6 (PERF.md).
template <int N, int D, int RS>
__device__ __forceinline__ void accumulate_tile(float (&acc)[N / 8][4],
                                                const float (&x)[D / 8][4],
                                                const float* y_t) {
  using namespace hopper;
  constexpr int kSteps = 2;
  static_assert(D / 8 % kSteps == 0, "k-steps come in pairs");
#pragma unroll
  for (int j0 = 0; j0 < D / 8; j0 += kSteps) {
    FragA a[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const float(&xj)[4] = x[j0 + j];
      a[j] = split_a(xj[0], xj[2], xj[1], xj[3]);
    }
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const float* y_j = y_t + 8 * (j0 + j) * RS + 8 * n;
        mma_3xtf32(part, a[j], y_j[0], y_j[RS]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
    }
  }
}

// dQ in fp32 on the tensor cores, laid out as flash_fwd_f32: a block of
// four warps owns (b, q-head, 64-row q tile), a warp 16 q rows, and walks
// 32-key K/V tiles (up to the diagonal when causal); grid y walks the q
// tiles from the last, the heaviest. Q and dO come in once by cp.async,
// lse and D of the lane's rows g and g + 8 once into registers. A key
// tile: dP = dO.V^T, S = Q.K^T, P = exp(S * scale - lse) (masked pairs 0;
// only the diagonal and ragged tiles evaluate the mask; a warp skips the
// tiles wholly above its rows), dS = P * (dP - D), dQ += dS.K through
// accumulate_tile, dS as it lies (k-step j's (t, t + 4) are keys 8j + 2t
// and 8j + 2t + 1, where S's accumulator holds them). dP comes first, so
// the next V tile lands while S and dS.K run and the next K tile while
// the next dP runs. `scale` is applied once, at the store.
// K is read two ways: as S's B operand at (row g, column t) and as dS.K's
// at (rows 2t and 2t + 1, column g). Rows of HD + 4 floats put both reads
// on 32 distinct banks, as single floats, and Q, which shares K's depth
// order in S, is read the same way. dO and V serve only dP: the forward's
// float4 reads at (row g, column 4t), the depth permuted, rows of HD + 16
// floats. 103.5 KB at hd = 128: two blocks an SM.
constexpr int kDqF32Threads = 128;  // four warps, 16 q rows each
constexpr int kDqF32BM = 64;        // q rows a block
constexpr int kDqF32BN = 32;        // keys a K/V tile

template <int HD>
constexpr size_t f32_dq_smem_bytes() {
  // Q and a K tile with rows of HD + 4 floats, dO and a V tile with rows
  // of HD + 16.
  return sizeof(float) * (kDqF32BM + kDqF32BN) * ((HD + 4) + (HD + 16));
}

template <int HD>
__global__ void __launch_bounds__(kDqF32Threads, 2)
    flash_bwd_dq_f32(const F32Params p) {
  using namespace hopper;
  constexpr int QS = HD + 4, OS = HD + 16, BM = kDqF32BM, BN = kDqF32BN;
  constexpr int T = kDqF32Threads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [BM][QS]
  float* sK = sQ + BM * QS;                        // [BN][QS]
  float* sO = sK + BN * QS;                        // dO, [BM][OS]
  float* sV = sO + BM * OS;                        // [BN][OS]

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 16 * warp;
  const int qpos[2] = {row0 + g, row0 + g + 8};
  const float* k = p.k + b * p.in[1][0] + kh * p.in[1][2];
  const float* v = p.v + b * p.in[2][0] + kh * p.in[2][2];
  const int q_end = min(q0 + BM, p.S);
  const int n_kt = ((p.causal ? q_end : p.S) + BN - 1) / BN;

  cp_async_rows<HD, BM, QS, T>(smem_u32(sQ),
                               p.q + b * p.in[0][0] + h * p.in[0][2],
                               p.in[0][1], q0, p.S);
  cp_async_rows<HD, BM, OS, T>(smem_u32(sO),
                               p.dout + b * p.in[3][0] + h * p.in[3][2],
                               p.in[3][1], q0, p.S);
  cp_async_rows<HD, BN, OS, T>(smem_u32(sV), v, p.in[2][1], 0, p.S);
  cp_async_commit();
  cp_async_rows<HD, BN, QS, T>(smem_u32(sK), k, p.in[1][1], 0, p.S);
  cp_async_commit();

  float lse[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qpos[r] < p.S;
    const long long i = static_cast<long long>(bh) * p.S + qpos[r];
    lse[r] = in ? p.lse[i] : 0.f;
    dsum[r] = in ? p.dsum[i] : 0.f;
  }
  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  }
  const float* q_g = sQ + (16 * warp + g) * QS + t;     // A of S
  const float* k_g = sK + g * QS + t;                   // B of S
  const float* k_t = sK + 2 * t * QS + g;               // B of dS.K
  const float* o_g = sO + (16 * warp + g) * OS + 4 * t;  // A of dP
  const float* v_g = sV + g * OS + 4 * t;               // B of dP

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    // Causal: a tile wholly above the warp's rows gives dS = 0.
    const bool live = !p.causal || k0 <= row0 + 15;
    cp_async_wait<1>();  // this V tile (first: and Q and dO)
    __syncthreads();
    float dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
    }
    if (live) {
#pragma unroll
      for (int kp = 0; kp < HD / 16; ++kp) {
        const float4 oa = *reinterpret_cast<const float4*>(o_g + 16 * kp);
        const float4 ob =
            *reinterpret_cast<const float4*>(o_g + 8 * OS + 16 * kp);
        const FragA a0 = split_a(oa.x, ob.x, oa.y, ob.y);
        const FragA a1 = split_a(oa.z, ob.z, oa.w, ob.w);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float4 vb =
              *reinterpret_cast<const float4*>(v_g + 8 * j * OS + 16 * kp);
          mma_3xtf32(dp[j], a0, vb.x, vb.y);
          mma_3xtf32(dp[j], a1, vb.z, vb.w);
        }
      }
    }
    __syncthreads();  // every warp has read this V tile
    if (kt + 1 < n_kt) {
      cp_async_rows<HD, BN, OS, T>(smem_u32(sV), v, p.in[2][1], k0 + BN, p.S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this K tile
    __syncthreads();
    if (live) {
      float s[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int c = 8 * kk;
        const FragA a = split_a(q_g[c], q_g[8 * QS + c], q_g[c + 4],
                                q_g[8 * QS + c + 4]);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          mma_3xtf32(s[j], a, k_g[8 * j * QS + c], k_g[8 * j * QS + c + 4]);
        }
      }
      // s becomes dS = P * (dP - D).
      const bool masked = k0 + BN > p.S || (p.causal && k0 + BN - 1 > row0);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
          float pr = expf(s[j][e] * p.scale - lse[r]);
          if (masked && (key >= p.S || (p.causal && key > qpos[r]))) {
            pr = 0.f;
          }
          s[j][e] = pr * (dp[j][e] - dsum[r]);
        }
      }
      accumulate_tile<HD, BN, QS>(dq, s, k_t);
    }
    __syncthreads();  // every warp has read this K tile
    if (kt + 1 < n_kt) {
      cp_async_rows<HD, BN, QS, T>(smem_u32(sK), k, p.in[1][1], k0 + BN, p.S);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.S) continue;
    float* out = p.dq + b * p.out[0][0] + qpos[r] * p.out[0][1] +
                 h * p.out[0][2] + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
    }
  }
}

// dK/dV in fp32 on the tensor cores (3xTF32 mma.sync m16n8k8, hopper.cuh).
// A block of four warps owns (b, kv-head, 32-key tile) and walks the
// group's q-heads and their 32-row Q/dO tiles (from the diagonal tile on
// when causal). K and V stay in shared memory; Q, dO and the tile's lse
// and D come in by cp.async into two buffers, the next tile's while this
// one is computed; two blocks an SM.
// Warps pair up on 16 keys: in each pair one warp computes S^T = K.Q^T
// and P^T, the other dP^T = V.dO^T; they swap those tiles through shared
// memory (lane to lane: both hold them in the same fragment layout), form
// dS^T = P^T * (dP^T - D), and each owns half of hd for both dK += dS^T.Q
// and dV += P^T.dO. So no product is computed twice and a thread keeps
// HD / 2 columns of dK and of dV (at hd = 128, four full-width
// accumulators left no registers: the kernel spilled). Keys are the
// accumulator rows, so dK and dV build up in registers with no transpose,
// and the group sum stays there (deterministic, no atomics).
// In dK and dV the depth (q rows) of k-step j is permuted so that the A
// fragment's (t, t + 4) are rows 8j + 2t and 8j + 2t + 1, where S^T's
// accumulator holds them: P^T and dS^T feed the products as they lie, and
// the B fragments read those two rows of Q and dO. Shared tiles have rows
// of HD + 4 floats: the A fragments of K and V (row g, column t), the B
// fragments of S^T and dP^T (row g, column t) and those of dK and dV (row
// 2t, column g) each fall on 32 distinct banks.
constexpr int kDkvF32Threads = 128;
constexpr int kDkvF32BN = 32;  // keys a block: two pairs of warps
constexpr int kDkvF32BM = 32;  // q rows a Q/dO tile

template <int HD>
constexpr size_t f32_dkv_smem_bytes() {
  // K and V, two buffers of Q and dO (rows of HD + 4 floats) and of the Q
  // tile's lse and D, each pair's two swapped tiles.
  return sizeof(float) * ((2 * kDkvF32BN + 4 * kDkvF32BM) * (HD + 4) +
                          4 * kDkvF32BM + 2 * 2 * kDkvF32BM * 16);
}

template <int HD>
__global__ void __launch_bounds__(kDkvF32Threads, 2)
    flash_bwd_dkv_f32(const F32Params p) {
  using namespace hopper;
  constexpr int RS = HD + 4, BN = kDkvF32BN, BM = kDkvF32BM;
  constexpr int T = kDkvF32Threads, HALF = HD / 2;
  constexpr int kSwap = BM / 8 * 4 * 32;  // floats of one swapped tile
  constexpr int kBuf = 2 * BM * RS + 2 * BM;  // Q, dO, lse, D of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [BN][RS]
  float* sV = sK + BN * RS;                        // [BN][RS]
  float* sX = sV + BN * RS;                        // [pair][role][kSwap]
  // Buffer i: Q [BM][RS], dO [BM][RS], lse [BM], D [BM].
  float* buf0 = sX + 4 * kSwap;

  const int k0 = blockIdx.y * BN;  // the first key tiles are the heaviest
  const int b = blockIdx.x / p.KH, kh = blockIdx.x % p.KH;
  const int group = p.H / p.KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // Warps `pair` and `pair` + 2 share keys k0 + 16 pair .. + 15; `role` 0
  // computes S^T and P^T, role 1 dP^T; each keeps columns
  // HALF * role .. + HALF - 1 of dK and dV.
  const int pair = warp % 2, role = warp / 2;
  const int key0 = k0 + 16 * pair;
  const int kpos[2] = {key0 + g, key0 + g + 8};
  // Causal: q tiles wholly above the diagonal see none of these keys.
  const int first_qt = p.causal ? k0 / BM : 0;
  const int n_qt = (p.S + BM - 1) / BM - first_qt;  // a q-head
  const int n_it = group * n_qt;

  // Q rows, dO rows, lse and D of item `it` (q-head it / n_qt, its
  // (it % n_qt)-th tile) into buffer it % 2, as one commit group.
  auto load_tile = [&](int it) {
    const int hq = kh * group + it / n_qt;
    const int q0 = (first_qt + it % n_qt) * BM;
    float* buf = buf0 + (it % 2) * kBuf;
    cp_async_rows<HD, BM, RS, T>(smem_u32(buf),
                                 p.q + b * p.in[0][0] + hq * p.in[0][2],
                                 p.in[0][1], q0, p.S);
    cp_async_rows<HD, BM, RS, T>(smem_u32(buf + BM * RS),
                                 p.dout + b * p.in[3][0] + hq * p.in[3][2],
                                 p.in[3][1], q0, p.S);
    if (threadIdx.x < 2 * BM) {  // lse then D
      const int r = threadIdx.x % BM;
      const bool in = q0 + r < p.S;
      const float* src = threadIdx.x < BM ? p.lse : p.dsum;
      const long long i = (static_cast<long long>(b) * p.H + hq) * p.S + q0 + r;
      cp_async4(smem_u32(buf + 2 * BM * RS + threadIdx.x), src + (in ? i : 0),
                in ? 4 : 0);
    }
    cp_async_commit();
  };

  cp_async_rows<HD, BN, RS, T>(smem_u32(sK),
                               p.k + b * p.in[1][0] + kh * p.in[1][2],
                               p.in[1][1], k0, p.S);
  cp_async_rows<HD, BN, RS, T>(smem_u32(sV),
                               p.v + b * p.in[2][0] + kh * p.in[2][2],
                               p.in[2][1], k0, p.S);
  load_tile(0);  // one group with K and V

  float dk[HALF / 8][4], dv[HALF / 8][4];
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }
  // This warp's product: S^T = K.Q^T (role 0) or dP^T = V.dO^T (role 1),
  // its B from the buffer's Q or dO.
  const float* a_g = (role == 0 ? sK : sV) + (16 * pair + g) * RS + t;
  float* x_mine = sX + (2 * pair + role) * kSwap + lane;
  const float* x_other = sX + (2 * pair + 1 - role) * kSwap + lane;

  for (int it = 0; it < n_it; ++it) {
    const int q0 = (first_qt + it % n_qt) * BM;
    // This tile has landed, and every warp is done with the last one: its
    // buffer takes the next tile, which lands while this one is computed.
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_it) load_tile(it + 1);
    const float* sQ = buf0 + (it % 2) * kBuf;
    const float* sO = sQ + BM * RS;
    const float* sL = sO + BM * RS;
    const float* sD = sL + BM;
    const float* b_g = (role == 0 ? sQ : sO) + g * RS + t;
    const float* q_t = sQ + 2 * t * RS + g + HALF * role;  // B of dK
    const float* o_t = sO + 2 * t * RS + g + HALF * role;  // B of dV
    // x: S^T then P^T (role 0), or dP^T (role 1). The depth loop indexes
    // only shared memory by kk and is unrolled by 2, not 16, so that the
    // loads and splits the compiler hoists stay within the registers.
    float x[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < HD / 8; ++kk) {
      const int c = 8 * kk;
      const FragA a = split_a(a_g[c], a_g[8 * RS + c], a_g[c + 4],
                              a_g[8 * RS + c + 4]);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        mma_3xtf32(x[j], a, b_g[8 * j * RS + c], b_g[8 * j * RS + c + 4]);
      }
    }
    if (role == 0) {
      // P^T = exp(S^T * scale - lse), masked pairs 0 (only the diagonal
      // and ragged tiles evaluate the mask).
      const bool masked = q0 + BM > p.S || (p.causal && q0 < key0 + 15);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * t + (e & 1), qpos = q0 + r;
          float y = expf(x[j][e] * p.scale - sL[r]);
          if (masked && (qpos >= p.S || (p.causal && kpos[e >> 1] > qpos))) {
            y = 0.f;
          }
          x[j][e] = y;
        }
      }
    }
    // Swap with the pair's other warp: both then hold P^T and dP^T.
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x_mine[(4 * j + e) * 32] = x[j][e];
    }
    named_sync(1 + pair, 64);
    float pt[BM / 8][4], dst[BM / 8][4];  // P^T; dS^T = P^T * (dP^T - D)
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float other = x_other[(4 * j + e) * 32];
        pt[j][e] = role == 0 ? x[j][e] : other;
        const float dp = role == 0 ? other : x[j][e];
        dst[j][e] = pt[j][e] * (dp - sD[8 * j + 2 * t + (e & 1)]);
      }
    }
    accumulate_tile<HALF, BM, RS>(dk, dst, q_t);  // dK += dS^T . Q
    accumulate_tile<HALF, BM, RS>(dv, pt, o_t);   // dV += P^T . dO
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= p.S) continue;
    const int col = HALF * role + 2 * t;
    float* ok = p.dk + b * p.out[1][0] + kpos[r] * p.out[1][1] +
                kh * p.out[1][2] + col;
    float* ov = p.dv + b * p.out[2][0] + kpos[r] * p.out[2][1] +
                kh * p.out[2][2] + col;
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n) {
      *reinterpret_cast<float2*>(ok + 8 * n) =
          make_float2(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
      *reinterpret_cast<float2*>(ov + 8 * n) =
          make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- host

// The wrapper's launch plan: dQ grid x, y; dK/dV grid x, y; dQ and dK/dV
// threads a block; dQ and dK/dV shared-memory bytes; then four tensor
// maps of 12 values each, for q, k, v, dO: dims[4] (hd, heads, S, B), byte
// strides[3], box[4], swizzle bytes.
constexpr int kGeomHead = 8;
constexpr int kMapLen = 12;
constexpr long long kMaxSmem = 232448;

using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                        Params);

// Checks the plan's maps against the kernels' tiling (a box that never
// lands would leave a wait that never completes), encodes them, and
// launches `kernel` on the grid (gx, gy) with the plan's `threads` and
// `smem` bytes.
int launch(Kernel kernel, const Params& p, const void* const* operands,
           int hd, const long long* g, long long gx, long long gy,
           long long threads, size_t smem_needed, long long smem,
           cudaStream_t stream) {
  const int heads[4] = {p.H, p.KH, p.KH, p.H};  // q, k, v, dO
  if (threads != kThreads || smem < static_cast<long long>(smem_needed) ||
      smem > kMaxSmem || gx < 1 || gy < 1) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const long long* m = g + kGeomHead + i * kMapLen;
    if (!hopper::bf16_map_ok(m, hd, heads[i], p.S, p.B, kBoxRows)) {
      return cudaErrorInvalidValue;
    }
    const int err = hopper::encode_bf16_map(&maps[i], operands[i], m);
    if (err != 0) return err;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                           p);
  return cudaGetLastError();
}

Params make_params(const void* lse, const void* dsum, void* dq, void* dk,
                   void* dv, int B, int S, int H, int KH,
                   const long long* st, int causal, float scale) {
  return Params{static_cast<const float*>(lse),
                static_cast<const float*>(dsum),
                static_cast<bf16*>(dq),
                static_cast<bf16*>(dk),
                static_cast<bf16*>(dv),
                B, S, H, KH,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                causal, scale};
}

// The fp32 plan: the same head (grids, threads, shared memory), then 12
// element strides, dims (b, s, head) of q, k, v, dO, where the bf16 plan
// has its tensor maps. `want_threads` is the kernel's block size.
using F32Kernel = void (*)(F32Params);

int launch_f32(F32Kernel kernel, F32Params p, const long long* g,
               long long gx, long long gy, long long threads,
               int want_threads, size_t smem_needed, long long smem,
               cudaStream_t stream) {
  if (threads != want_threads ||
      smem < static_cast<long long>(smem_needed) ||
      smem > kMaxSmem || gx < 1 || gy < 1) {
    return cudaErrorInvalidValue;
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 3; ++j) p.in[i][j] = g[kGeomHead + 3 * i + j];
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  // All of the SM's unified cache as shared memory: two blocks an SM.
  const cudaError_t carve = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return carve;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  kernel<<<grid, want_threads, smem, stream>>>(p);
  return cudaGetLastError();
}

F32Params make_f32_params(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* dsum, void* dq, void* dk, void* dv,
                          int B, int S, int H, int KH, const long long* st,
                          int causal, float scale) {
  F32Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<const float*>(dsum);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.B = B;
  p.S = S;
  p.H = H;
  p.KH = KH;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) p.out[i][j] = st[3 * i + j];
  }
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

// Plain C entries, bound with ctypes. bf16 q, k, v, dout are read through
// the plan's tensor maps, fp32 ones through the plan's strides; lse and
// dsum are [B, H, S] fp32, contiguous. `out_strides` holds 9 element
// strides: dims (b, s, head) of dq, dk, dv; the last dim of every operand
// is contiguous. `geometry` is the wrapper's launch plan (see above).
// dtype: 0 = fp32, 1 = bf16. Each returns 0 on success, else a
// cudaError_t or hopper::kTensorMapError + CUresult.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* dsum, void* dq, int dtype, int B,
                            int S, int H, int KH, int hd,
                            const long long* out_strides,
                            const long long* geometry, int causal,
                            float scale, void* stream) {
  const long long* g = geometry;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    // x walks (b, h); y walks 64-row q tiles, the last first.
    if (g[0] != static_cast<long long>(B) * H ||
        g[1] != (S + kDqF32BM - 1) / kDqF32BM) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const F32Params p =
        make_f32_params(q, k, v, dout, lse, dsum, dq, nullptr, nullptr, B, S,
                        H, KH, out_strides, causal, scale);
    if (hd == 128) {
      return launch_f32(flash_bwd_dq_f32<128>, p, g, g[0], g[1], g[4],
                        kDqF32Threads, f32_dq_smem_bytes<128>(), g[6], st);
    }
    if (hd == 64) {
      return launch_f32(flash_bwd_dq_f32<64>, p, g, g[0], g[1], g[4],
                        kDqF32Threads, f32_dq_smem_bytes<64>(), g[6], st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // x walks (b, h); y walks 128-row q tiles, the last first.
  if (dtype != 1 || g[0] != static_cast<long long>(B) * H ||
      g[1] != (S + kDqBM - 1) / kDqBM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(lse, dsum, dq, nullptr, nullptr, B, S, H, KH,
                               out_strides, causal, scale);
  const void* operands[4] = {q, k, v, dout};
  if (hd == 128) {
    return launch(flash_bwd_dq_bf16<128>, p, operands, hd, g, g[0], g[1],
                  g[4], dq_smem_bytes<128>(), g[6], st);
  }
  if (hd == 64) {
    return launch(flash_bwd_dq_bf16<64>, p, operands, hd, g, g[0], g[1],
                  g[4], dq_smem_bytes<64>(), g[6], st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dsum, void* dk, void* dv, int dtype,
                             int B, int S, int H, int KH, int hd,
                             const long long* out_strides,
                             const long long* geometry, int causal,
                             float scale, void* stream) {
  const long long* g = geometry;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    // x walks (b, kv-head); y walks 32-key tiles, the first first.
    if (g[2] != static_cast<long long>(B) * KH ||
        g[3] != (S + kDkvF32BN - 1) / kDkvF32BN) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const F32Params p =
        make_f32_params(q, k, v, dout, lse, dsum, nullptr, dk, dv, B, S, H,
                        KH, out_strides, causal, scale);
    if (hd == 128) {
      return launch_f32(flash_bwd_dkv_f32<128>, p, g, g[2], g[3], g[5],
                        kDkvF32Threads, f32_dkv_smem_bytes<128>(), g[7],
                        st);
    }
    if (hd == 64) {
      return launch_f32(flash_bwd_dkv_f32<64>, p, g, g[2], g[3], g[5],
                        kDkvF32Threads, f32_dkv_smem_bytes<64>(), g[7], st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // x walks (b, kv-head); y walks 128-key tiles, the first first.
  if (dtype != 1 || g[2] != static_cast<long long>(B) * KH ||
      g[3] != (S + kDkvBN - 1) / kDkvBN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(lse, dsum, nullptr, dk, dv, B, S, H, KH,
                               out_strides, causal, scale);
  const void* operands[4] = {q, k, v, dout};
  if (hd == 128) {
    return launch(flash_bwd_dkv_bf16<128>, p, operands, hd, g, g[2], g[3],
                  g[5], dkv_smem_bytes<128>(), g[7], st);
  }
  if (hd == 64) {
    return launch(flash_bwd_dkv_bf16<64>, p, operands, hd, g, g[2], g[3],
                  g[5], dkv_smem_bytes<64>(), g[7], st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return hopper::error_string(err);
}
