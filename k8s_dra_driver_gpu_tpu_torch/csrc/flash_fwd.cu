// Flash-attention forward for Hopper (sm_90a): causal / non-causal GQA
// attention with an online softmax, read straight from the [B, S, H, hd]
// layout through strides.
//
// Replaces the TPU kernel `_flash_kernel`
// (k8s_dra_driver_gpu_tpu/ops/flash_attention.py:40-101), both its
// forward-only variant (pallas_call at :419, the serving path) and its
// with-lse variant (:428): same arithmetic, not the same blocking.
//   * scores = (q . k) in fp32, then * scale; masked scores are -1e30
//     (not -inf); running max m, normaliser l and the output accumulator
//     stay in fp32; p is cast to the input type before the P.V product;
//     l is clamped at 1e-30; lse = m + log(l).
//   * GQA by index: q-head h reads kv-head h / (H / K); K/V are never
//     repeated. Causal mode stops the k loop at the diagonal tile.
//   * Ragged S is masked in-kernel (rows past S are staged as zeros, keys
//     past S are masked); only rows < S of O and lse are written.
//
// Bound on an H100 SXM at the serving shape (B=4, S=2048, H=32, K=8,
// hd=128, causal, bf16): 4*B*H*hd*S*(S+1)/2 ~ 137 GFLOP over 989 TFLOP/s
// (bf16 dense) = 0.14 ms, against ~168 MB of Q/K/V/O over 3.35 TB/s =
// 0.05 ms: compute-bound, so the tensor cores decide.
//
// Design: the simple form that is right first.
//   * bf16 (the serving path): one block of 4 warps per (b*h, 64-row
//     q tile); each warp owns 16 q rows. Q/K/V tiles are staged in
//     dynamic shared memory with 16-byte loads (rows padded by 16 bytes
//     so fragment reads hit distinct banks; 52 KB at hd=128, over the
//     48 KB static limit). Both products run on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate). The S fragment of
//     Q.K^T is re-packed in registers as the A fragment of P.V, so P
//     never touches shared memory. No cp.async / TMA / wgmma pipelining
//     yet: loads and math do not overlap.
//   * fp32: the same loop with scalar FMAs (fp32 has no tensor-core path
//     that keeps fp32 products exact) on 32x32 tiles.
//   * Grid x walks (b, h) and y walks q tiles from the last: the heaviest
//     causal tiles of every head start first and do not trail the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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

constexpr int kMmaBM = 64;
constexpr int kMmaBN = 64;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
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

// Stage rows [s0, s0 + ROWS) of one head into shared memory (row stride
// LD elements) with 16-byte loads; rows at or past S become zeros so that
// masked keys can never bring NaN into P.V.
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int s0,
                                           int S) {
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

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  constexpr int BM = kMmaBM, BN = kMmaBN;
  constexpr int LD = HD + 8;  // 16-byte pad per shared-memory row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kh * p.v_sh;

  stage_bf16<BM, HD, LD>(Qs, q, p.q_ss, q0, p.S);
  __syncthreads();

  // This warp's 16 q rows as A fragments, for every 16-wide slice of hd.
  const int qr = warp * 16 + g;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* r0 = Qs + qr * LD + kk * 16 + 2 * t;
    qa[kk][0] = ld32(r0);
    qa[kk][1] = ld32(r0 + 8 * LD);
    qa[kk][2] = ld32(r0 + 8);
    qa[kk][3] = ld32(r0 + 8 * LD + 8);
  }

  // Accumulator fragments: o[nd][0..1] are row qr, columns nd*8 + 2t,
  // +1; o[nd][2..3] the same columns of row qr + 8.
  float o[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int qpos[2] = {q0 + qr, q0 + qr + 8};

  const int q_end = min(q0 + BM, p.S);
  const int n_kt = p.causal ? (q_end + BN - 1) / BN : (p.S + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_bf16<BN, HD, LD>(Ks, k, p.k_ss, k0, p.S);
    stage_bf16<BN, HD, LD>(Vs, v, p.v_ss, k0, p.S);
    __syncthreads();

    // s = Q . K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        mma_bf16(s[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
    }

    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const float x = s[j][e] * p.scale;
        s[j][e] = key_valid(p, kpos, qpos[e >> 1]) ? x : kNegInf;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mt[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        ls[e >> 1] += s[j][e];
      }
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // o += P . V: the C fragments of two adjacent n-tiles of s are the A
    // fragment of one 16-key slice, rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack(__floats2bfloat162_rn(s[2 * kk][0], s[2 * kk][1])),
          pack(__floats2bfloat162_rn(s[2 * kk][2], s[2 * kk][3])),
          pack(__floats2bfloat162_rn(s[2 * kk + 1][0], s[2 * kk + 1][1])),
          pack(__floats2bfloat162_rn(s[2 * kk + 1][2], s[2 * kk + 1][3])),
      };
      const __nv_bfloat16* vr = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        const __nv_bfloat16* vc = vr + nd * 8;
        const uint32_t b0 = pack(__halves2bfloat162(vc[0], vc[LD]));
        const uint32_t b1 = pack(__halves2bfloat162(vc[8 * LD], vc[9 * LD]));
        mma_bf16(o[nd], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = fmaxf(quad_sum(l[r]), 1e-30f);
    if (qpos[r] >= p.S) continue;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                         qpos[r] * p.o_ss + h * p.o_sh + 2 * t;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(out + nd * 8) =
          __floats2bfloat162_rn(o[nd][2 * r] / l_safe,
                                o[nd][2 * r + 1] / l_safe);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[static_cast<long long>(bh) * p.S + qpos[r]] =
          m[r] + logf(l_safe);
    }
  }
}

// ---------------------------------------------------------------- fp32

constexpr int kFmaBM = 32;
constexpr int kFmaBN = 32;

// Four threads per q row: thread (r, sub) scores keys sub + 4i and owns
// output columns sub + 4c.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Params p) {
  constexpr int BM = kFmaBM, BN = kFmaBN;
  constexpr int QS = HD + 1;  // odd row strides: conflict-free column walks
  constexpr int PS = BN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BM][QS]
  float* Ks = Qs + BM * QS;                          // [BN][QS]
  float* Vs = Ks + BN * QS;                          // [BN][HD]
  float* Ps = Vs + BN * HD;                          // [BM][PS]

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / (p.H / p.KH);
  const int r = threadIdx.x >> 2, sub = threadIdx.x & 3;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;

  for (int e = threadIdx.x; e < BM * HD; e += kThreads) {
    const int row = e / HD, col = e % HD, s = q0 + row;
    Qs[row * QS + col] = s < p.S ? q[s * p.q_ss + col] : 0.f;
  }

  float o[HD / 4];
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) o[c] = 0.f;
  float m = kNegInf, l = 0.f;
  const int qpos = q0 + r;

  const int q_end = min(q0 + BM, p.S);
  const int n_kt = p.causal ? (q_end + BN - 1) / BN : (p.S + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    for (int e = threadIdx.x; e < BN * HD; e += kThreads) {
      const int row = e / HD, col = e % HD, s = k0 + row;
      const bool in = s < p.S;
      Ks[row * QS + col] = in ? k[s * p.k_ss + col] : 0.f;
      Vs[row * HD + col] = in ? v[s * p.v_ss + col] : 0.f;
    }
    __syncthreads();

    float sc[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) sc[i] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * QS + d];
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) sc[i] += qd * Ks[(sub + 4 * i) * QS + d];
    }
    float mt = kNegInf;
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      const float x = sc[i] * p.scale;
      sc[i] = key_valid(p, k0 + sub + 4 * i, qpos) ? x : kNegInf;
      mt = fmaxf(mt, sc[i]);
    }
    const float m_new = fmaxf(m, quad_max(mt));
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      const float pi = expf(sc[i] - m_new);
      ls += pi;
      Ps[r * PS + sub + 4 * i] = pi;
    }
    l = l * alpha + quad_sum(ls);
    m = m_new;
    __syncwarp();  // the row's four threads read each other's P
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) o[c] *= alpha;
    for (int j = 0; j < BN; ++j) {
      const float pj = Ps[r * PS + j];
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) o[c] += pj * Vs[j * HD + sub + 4 * c];
    }
  }

  if (qpos < p.S) {
    const float l_safe = fmaxf(l, 1e-30f);
    float* out = static_cast<float*>(p.o) + b * p.o_sb + qpos * p.o_ss +
                 h * p.o_sh;
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) out[sub + 4 * c] = o[c] / l_safe;
    if (p.lse != nullptr && sub == 0) {
      p.lse[static_cast<long long>(bh) * p.S + qpos] = m + logf(l_safe);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int block_m, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // x walks (b, h); y walks q tiles, last (heaviest causal) tile first.
  const dim3 grid(p.B * p.H, (p.S + block_m - 1) / block_m);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
size_t bf16_smem() {
  return 3 * kMmaBM * (HD + 8) * sizeof(__nv_bfloat16);
}

template <int HD>
size_t f32_smem() {
  return (2 * kFmaBM * (HD + 1) + kFmaBN * HD + kFmaBM * (kFmaBN + 1)) *
         sizeof(float);
}

}  // namespace

// Plain C entry, bound with ctypes. Strides are in elements; the last dim
// of every tensor is contiguous. dtype: 0 = fp32, 1 = bf16. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int dtype, int B, int S, int H,
                         int KH, int hd, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_ss,
                         long long k_sh, long long v_sb, long long v_ss,
                         long long v_sh, long long o_sb, long long o_ss,
                         long long o_sh, int causal, float scale,
                         void* stream) {
  const Params p{q,    k,    v,    o,    static_cast<float*>(lse),
                 B,    S,    H,    KH,   q_sb,
                 q_ss, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, o_sb, o_ss,
                 o_sh, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hd == 128)
    return launch(flash_fwd_bf16<128>, kMmaBM, bf16_smem<128>(), p, st);
  if (dtype == 1 && hd == 64)
    return launch(flash_fwd_bf16<64>, kMmaBM, bf16_smem<64>(), p, st);
  if (dtype == 0 && hd == 128)
    return launch(flash_fwd_f32<128>, kFmaBM, f32_smem<128>(), p, st);
  if (dtype == 0 && hd == 64)
    return launch(flash_fwd_f32<64>, kFmaBM, f32_smem<64>(), p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
