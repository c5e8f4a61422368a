// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV of causal /
// non-causal GQA attention, rebuilt from the forward's logsumexp, read
// straight from the [B, S, H, hd] / [B, S, K, hd] layout through strides.
//
// Replaces the TPU kernels
//   * `_flash_dq_kernel` (k8s_dra_driver_gpu_tpu/ops/flash_attention.py:104,
//     pallas_call at :512) with `flash_bwd_dq_bf16`, and
//   * `_flash_dkv_kernel` (:157, pallas_call at :536) with
//     `flash_bwd_dkv_bf16`.
// Same arithmetic and the same casts:
//   s  = (q . k) in fp32, * scale; masked entries give p = 0 (the TPU kernel
//        masks s to -1e30, whose exp(s - lse) is 0);
//   p  = exp(s - lse)                 (fp32)
//   dp = dO . v                       (bf16 in, fp32 accumulate)
//   ds = p * (dp - D), D = rowsum(dO * O) in fp32, computed by the caller
//   dQ = scale * sum_k bf16(ds) . k, written in q's dtype
//   dV = sum_q bf16(p)^T . dO,  dK = scale * sum_q bf16(ds)^T . q,
//        written in k/v's dtype.
// GQA by index: q-head h reads kv-head h / (H / K). The TPU version writes
// per-q-head fp32 dK/dV partials [B*H, S_pad, hd] and sums each group
// outside the kernel; here one block owns a kv-head's key tile and loops
// over the group's q-heads, so the group sum stays in fp32 registers and
// never makes an fp32 round trip through device memory.
// Ragged S is masked in-kernel: rows past S are staged as zeros and give
// p = 0; only rows < S are written. No padding copies.
//
// Bound on an H100 SXM at the training shape (B=4, S=4096, H=16, K=8,
// hd=128, causal, bf16), over the S(S+1)/2 unmasked pairs of every (b, h):
//   dQ:    3 products (Q.K^T, dO.V^T, dS.K)       = 6*hd FLOP a pair,
//          0.41 TFLOP at 989 TFLOP/s = 0.42 ms; ~0.27 GB read/written at
//          3.35 TB/s = 0.08 ms;
//   dK/dV: 4 products (K.Q^T, V.dO^T, P^T.dO, dS^T.Q) = 8*hd FLOP a pair,
//          0.55 TFLOP = 0.56 ms; ~0.27 GB = 0.08 ms.
// Both compute-bound: the tensor cores decide.
//
// Design: the simple form that is right first (no wgmma, TMA or cp.async
// pipelining; loads and math do not overlap).
//   * dQ: one block of 4 warps per (b*h, 64-row q tile), each warp owning
//     16 q rows. Q and dO are staged once in shared memory; the tile's lse
//     and D sit in registers. The block walks 64-key K/V tiles up to the
//     diagonal (all of S when non-causal). Q.K^T and dO.V^T run as
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate); the accumulator
//     fragment of dS is re-packed in registers as the A fragment of dS.K,
//     so P and dS never touch shared memory. dQ accumulates in fp32
//     registers. Grid y runs the heaviest causal tiles first.
//   * dK/dV: one block of 4 warps per (b*kv-head, 64-key tile), each warp
//     owning 16 keys. The K/V tile stays in shared memory; dK and dV
//     accumulate in fp32 registers. The block loops over the GQA group's
//     q-heads and, for each, over 32-row q tiles from the diagonal on,
//     computing the transposed products K.Q^T and V.dO^T so that keys are
//     the fragment rows; P^T and dS^T are re-packed in registers as the A
//     fragments of P^T.dO and dS^T.Q.
//   * Shared-memory rows are padded by 16 bytes so fragment reads hit
//     distinct banks; both kernels use dynamic shared memory above the
//     48 KB static limit (68 KB and 52.5 KB at hd=128).
//   * bf16 only. fp32 inputs are refused by the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kDqBM = 64;   // q rows of a dQ block (16 per warp)
constexpr int kDqBN = 64;   // keys of a K/V tile in the dQ loop
constexpr int kDkvBN = 64;  // keys of a dK/dV block (16 per warp)
constexpr int kDkvBM = 32;  // q rows of a tile in the dK/dV loop
constexpr int kStrides = 21;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;   // [B, H, S] fp32
  const float* dsum;  // [B, H, S] fp32: rowsum(dO * O)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, S, H, KH;
  // Element strides of dims (b, s, head) of q, k, v, dout, dq, dk, dv.
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int causal;
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const bf16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return pack(__floats2bfloat162_rn(lo, hi));
}

// D += A (16x16, row) * B (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [r, r + 16) and columns [c, c + 16) of a
// row-major shared-memory tile with row stride LD (lane: g = lane / 4,
// t = lane % 4).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r, int c, int g, int t) {
  const bf16* p = tile + (r + g) * LD + c + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// The B fragment (16 deep x 8 wide) whose column n is row (r + n) of the
// tile, read along the row from column c: B = tile[r:r+8, c:c+16]^T.
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const bf16* tile, int r, int c,
                                            int g, int t) {
  const bf16* p = tile + (r + g) * LD + c + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// The B fragment (16 deep x 8 wide) taken as it lies in the tile: rows
// [r, r + 16) are the depth, columns [c, c + 8) the width.
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const bf16* tile, int r, int c,
                                            int g, int t) {
  const bf16* p = tile + (r + 2 * t) * LD + c + g;
  b0 = pack(__halves2bfloat162(p[0], p[LD]));
  b1 = pack(__halves2bfloat162(p[8 * LD], p[9 * LD]));
}

// Stage rows [s0, s0 + ROWS) of one head into shared memory (row stride
// LD elements) with 16-byte loads; rows at or past S become zeros.
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long row_stride, int s0, int S) {
  constexpr int kChunks = HD / 8;
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int s = s0 + row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) {
      val = *reinterpret_cast<const uint4*>(src + s * row_stride + col);
    }
    *reinterpret_cast<uint4*>(dst + row * LD + col) = val;
  }
}

__device__ __forceinline__ bool pair_valid(const Params& p, int kpos,
                                           int qpos) {
  return kpos < p.S && qpos < p.S && (!p.causal || kpos <= qpos);
}

// ------------------------------------------------------------------ dQ

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(Params p) {
  constexpr int BM = kDqBM, BN = kDqBN;
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BM * LD;
  bf16* Ks = dOs + BM * LD;
  bf16* Vs = Ks + BN * LD;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  stage<BM, HD, LD>(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S);
  stage<BM, HD, LD>(dOs, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0,
                    p.S);
  const bf16* k = p.k + b * p.k_sb + kh * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + kh * p.v_sh;

  // This thread's rows: warp * 16 + g and + 8 of the tile.
  const int qr = warp * 16;
  const int qpos[2] = {q0 + qr + g, q0 + qr + g + 8};
  float lse[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = static_cast<long long>(bh) * p.S + qpos[r];
    lse[r] = qpos[r] < p.S ? p.lse[i] : 0.f;
    dsum[r] = qpos[r] < p.S ? p.dsum[i] : 0.f;
  }

  float dq[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
  }

  const int q_end = min(q0 + BM, p.S);
  const int n_kt = p.causal ? (q_end + BN - 1) / BN : (p.S + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage<BN, HD, LD>(Ks, k, p.k_ss, k0, p.S);
    stage<BN, HD, LD>(Vs, v, p.v_ss, k0, p.S);
    __syncthreads();

    // s = Q . K^T and dp = dO . V^T for 16 rows x 64 keys.
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, Qs, qr, kk * 16, g, t);
      load_a<LD>(da, dOs, qr, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t b0, b1;
        load_b_rows<LD>(b0, b1, Ks, j * 8, kk * 16, g, t);
        mma_bf16(s[j], qa, b0, b1);
        load_b_rows<LD>(b0, b1, Vs, j * 8, kk * 16, g, t);
        mma_bf16(dp[j], da, b0, b1);
      }
    }

    // ds = p * (dp - D), kept in s.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const float pv = pair_valid(p, kpos, qpos[r])
                             ? expf(s[j][e] * p.scale - lse[r])
                             : 0.f;
        s[j][e] = pv * (dp[j][e] - dsum[r]);
      }
    }

    // dq += bf16(ds) . K: two adjacent n-tiles of ds are the A fragment
    // of one 16-key slice.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t sa[4] = {
          pack2(s[2 * kk][0], s[2 * kk][1]),
          pack2(s[2 * kk][2], s[2 * kk][3]),
          pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        uint32_t b0, b1;
        load_b_cols<LD>(b0, b1, Ks, kk * 16, nd * 8, g, t);
        mma_bf16(dq[nd], sa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.S) continue;
    bf16* out = p.dq + b * p.dq_sb + qpos[r] * p.dq_ss + h * p.dq_sh + 2 * t;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(out + nd * 8) =
          __floats2bfloat162_rn(dq[nd][2 * r] * p.scale,
                                dq[nd][2 * r + 1] * p.scale);
    }
  }
}

// --------------------------------------------------------------- dK/dV

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16(Params p) {
  constexpr int BN = kDkvBN, BM = kDkvBM;
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BN * LD;
  bf16* Qs = Vs + BN * LD;
  bf16* dOs = Qs + BM * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + BM * LD);
  float* dsum_s = lse_s + BM;

  const int k0 = blockIdx.y * BN;
  const int bk = blockIdx.x;
  const int b = bk / p.KH, kh = bk % p.KH;
  const int group = p.H / p.KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  stage<BN, HD, LD>(Ks, p.k + b * p.k_sb + kh * p.k_sh, p.k_ss, k0, p.S);
  stage<BN, HD, LD>(Vs, p.v + b * p.v_sb + kh * p.v_sh, p.v_ss, k0, p.S);

  // This thread's keys: rows warp * 16 + g and + 8 of the tile.
  const int kr = warp * 16;
  const int kpos[2] = {k0 + kr + g, k0 + kr + g + 8};

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
  }

  const int n_qt = (p.S + BM - 1) / BM;
  // Causal: q tiles wholly above the diagonal see none of this key tile.
  const int first_qt = p.causal ? k0 / BM : 0;
  for (int hq = kh * group; hq < (kh + 1) * group; ++hq) {
    const bf16* q = p.q + b * p.q_sb + hq * p.q_sh;
    const bf16* dout = p.dout + b * p.do_sb + hq * p.do_sh;
    const long long row0 = (static_cast<long long>(b) * p.H + hq) * p.S;
    for (int qt = first_qt; qt < n_qt; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();  // every warp is done with the previous q tile
      stage<BM, HD, LD>(Qs, q, p.q_ss, q0, p.S);
      stage<BM, HD, LD>(dOs, dout, p.do_ss, q0, p.S);
      if (threadIdx.x < BM) {
        const int s = q0 + threadIdx.x;
        lse_s[threadIdx.x] = s < p.S ? p.lse[row0 + s] : 0.f;
        dsum_s[threadIdx.x] = s < p.S ? p.dsum[row0 + s] : 0.f;
      }
      __syncthreads();

      // s^T = K . Q^T and dp^T = V . dO^T for 16 keys x 32 q rows.
      float s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, Ks, kr, kk * 16, g, t);
        load_a<LD>(va, Vs, kr, kk * 16, g, t);
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          uint32_t b0, b1;
          load_b_rows<LD>(b0, b1, Qs, j * 8, kk * 16, g, t);
          mma_bf16(s[j], ka, b0, b1);
          load_b_rows<LD>(b0, b1, dOs, j * 8, kk * 16, g, t);
          mma_bf16(dp[j], va, b0, b1);
        }
      }

      // p^T in s (fp32), ds^T = p^T * (dp^T - D) in dp.
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          const float pv = pair_valid(p, kpos[e >> 1], q0 + col)
                               ? expf(s[j][e] * p.scale - lse_s[col])
                               : 0.f;
          s[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] - dsum_s[col]);
        }
      }

      // dv += bf16(p^T) . dO and dk += bf16(ds^T) . Q over 16-row slices
      // of the q tile.
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint32_t pa[4] = {
            pack2(s[2 * kk][0], s[2 * kk][1]),
            pack2(s[2 * kk][2], s[2 * kk][3]),
            pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
        const uint32_t sa[4] = {
            pack2(dp[2 * kk][0], dp[2 * kk][1]),
            pack2(dp[2 * kk][2], dp[2 * kk][3]),
            pack2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]),
        };
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
          uint32_t b0, b1;
          load_b_cols<LD>(b0, b1, dOs, kk * 16, nd * 8, g, t);
          mma_bf16(dv[nd], pa, b0, b1);
          load_b_cols<LD>(b0, b1, Qs, kk * 16, nd * 8, g, t);
          mma_bf16(dk[nd], sa, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= p.S) continue;
    bf16* dk_out =
        p.dk + b * p.dk_sb + kpos[r] * p.dk_ss + kh * p.dk_sh + 2 * t;
    bf16* dv_out =
        p.dv + b * p.dv_sb + kpos[r] * p.dv_ss + kh * p.dv_sh + 2 * t;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dk_out + nd * 8) =
          __floats2bfloat162_rn(dk[nd][2 * r] * p.scale,
                                dk[nd][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + nd * 8) =
          __floats2bfloat162_rn(dv[nd][2 * r], dv[nd][2 * r + 1]);
    }
  }
}

template <int HD>
size_t dq_smem() {
  return (2 * kDqBM + 2 * kDqBN) * (HD + 8) * sizeof(bf16);
}

template <int HD>
size_t dkv_smem() {
  return (2 * kDkvBN + 2 * kDkvBM) * (HD + 8) * sizeof(bf16) +
         2 * kDkvBM * sizeof(float);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dsum,
                   void* dq, void* dk, void* dv, int B, int S, int H, int KH,
                   const long long* st, int causal, float scale) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<const float*>(dsum);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = B;
  p.S = S;
  p.H = H;
  p.KH = KH;
  long long* fields[kStrides] = {
      &p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,  &p.k_sh,  &p.v_sb,
      &p.v_ss,  &p.v_sh,  &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb, &p.dq_ss,
      &p.dq_sh, &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh};
  for (int i = 0; i < kStrides; ++i) *fields[i] = st[i];
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

// Plain C entries, bound with ctypes. `strides` holds 21 element strides:
// dims (b, s, head) of q, k, v, dout, dq, dk, dv in that order; the last
// dim of every tensor is contiguous. lse and dsum are [B, H, S] fp32,
// contiguous. dtype: 1 = bf16 (the only one taken). Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* dsum, void* dq, int dtype, int B,
                            int S, int H, int KH, int hd,
                            const long long* strides, int causal, float scale,
                            void* stream) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, dout, lse, dsum, dq, nullptr,
                               nullptr, B, S, H, KH, strides, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // x walks (b, h); y walks q tiles, last (heaviest causal) tile first.
  const dim3 grid(B * H, (S + kDqBM - 1) / kDqBM);
  if (hd == 128) {
    return launch(flash_bwd_dq_bf16<128>, grid, dq_smem<128>(), p, st);
  }
  if (hd == 64) {
    return launch(flash_bwd_dq_bf16<64>, grid, dq_smem<64>(), p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dsum, void* dk, void* dv, int dtype,
                             int B, int S, int H, int KH, int hd,
                             const long long* strides, int causal,
                             float scale, void* stream) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, dout, lse, dsum, nullptr, dk, dv, B,
                               S, H, KH, strides, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // x walks (b, kv-head); y walks key tiles, first (heaviest causal) first.
  const dim3 grid(B * KH, (S + kDkvBN - 1) / kDkvBN);
  if (hd == 128) {
    return launch(flash_bwd_dkv_bf16<128>, grid, dkv_smem<128>(), p, st);
  }
  if (hd == 64) {
    return launch(flash_bwd_dkv_bf16<64>, grid, dkv_smem<64>(), p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
