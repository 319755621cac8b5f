// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel tpuframe/ops/flash_attention.py:_fwd_kernel
// (pallas_call in _flash_fwd).  It computes the same function: scores in
// f32 scaled by D**-0.5, an online softmax with a running max and
// normaliser, P rounded to V's type before the PV product, an f32
// accumulator, out written in q's type and the logsumexp in f32.  A row
// whose keys are all masked gives a zero output and lse = -1e30.
//
// What bounds it on the H100: at the serving shapes (one sequence, 12
// heads of 64, S <= 512) the work is small on both axes (a few MB moved,
// under a GFLOP), so the least time is about a microsecond and what the
// kernel really pays for is its own arithmetic: this first version does
// the two products per tile with FMAs on the CUDA cores, not on the
// tensor cores.  The design keeps what the TPU kernel keeps out of device
// memory: the S x S scores never leave the SM.  The TPU's sequential grid
// axis over K/V blocks becomes a loop inside one thread block, which
// stages each K/V tile in shared memory (as f32, rows padded by one word
// so that no two lanes of a warp hit one bank).  Tiles wholly above the
// diagonal are never loaded under `causal`, and the ragged edge is masked
// here, so any S works.  Moving the products to mma/wgmma is later work.
//
// Layout: q, k, v are [B, S, N, D] with unit stride on D and any other
// strides (in elements); out is a fresh contiguous [B, S_q, N, D] and lse
// a contiguous [B, N, S_q].  mask, when given, is [B, S_kv] int32,
// nonzero = attend.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;                      // query rows per block
constexpr int BK = 64;                      // keys per shared-memory tile
constexpr int ROW_GROUPS = 8;               // thread rows
constexpr int COL_LANES = 16;               // threads that share a row
constexpr int NT = ROW_GROUPS * COL_LANES;  // 128 threads
constexpr int RPT = BQ / ROW_GROUPS;        // query rows per thread
constexpr int CPT = BK / COL_LANES;         // keys per thread per tile
constexpr float NEG_INF = -1e30f;           // finite, so (x - x) stays 0

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;
  void* out;
  float* lse;
  int n_heads, s_q, s_kv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Max and sum over the 16 lanes that share a row: xor offsets below 16
// stay inside the half warp.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = COL_LANES / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = COL_LANES / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// One block per (batch * head, tile of BQ query rows).  Thread (ty, tx)
// owns query rows ty*RPT .. ty*RPT+RPT-1; for the scores it owns keys
// tx + 16*j of each tile, for the output head dims tx + 16*c.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  constexpr int DP = D + 1;     // padded smem row of Q and K
  constexpr int BKP = BK + 1;   // padded smem row of P
  constexpr int OPT = D / COL_LANES;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][DP]
  float* ks = qs + BQ * DP;     // [BK][DP]
  float* vs = ks + BK * DP;     // [BK][D]
  float* ps = vs + BK * D;      // [BQ][BKP]

  const int tid = threadIdx.x;
  const int ty = tid / COL_LANES, tx = tid % COL_LANES;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads, h = bh % p.n_heads;
  const int q0 = blockIdx.y * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int32_t* mask =
      p.mask != nullptr ? p.mask + static_cast<int64_t>(b) * p.s_kv : nullptr;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    qs[r * DP + c] =
        q0 + r < p.s_q ? to_f32(q[(q0 + r) * p.q_ss + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OPT; ++c) acc[i][c] = 0.f;
  }

  // Under `causal`, tiles that start past this block's last row lie wholly
  // above the diagonal and are skipped.
  const int kv_end = p.causal ? min(p.s_kv, q0 + BQ) : p.s_kv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's K, V and P are no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.s_kv;
      ks[r * DP + c] = in ? to_f32(k[(k0 + r) * p.k_ss + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(v[(k0 + r) * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RPT], kk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = qs[(ty * RPT + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kk[j] = ks[(tx + COL_LANES * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

    bool key_ok[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = k0 + tx + COL_LANES * j;
      key_ok[j] = col < p.s_kv && (mask == nullptr || mask[col] != 0);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      bool keep[CPT];
      float m_cur = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        keep[j] = key_ok[j] && (!p.causal || row >= k0 + tx + COL_LANES * j);
        s[i][j] = keep[j] ? s[i][j] * p.scale : NEG_INF;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
      m_cur = row_max(m_cur);
      const float m_new = fmaxf(m[i], m_cur);
      const float alpha = expf(m[i] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        // Explicit zero (not exp underflow): a fully masked row keeps
        // l == 0 and finalises to a zero output.
        const float e = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        p_sum += e;
        ps[(ty * RPT + i) * BKP + tx + COL_LANES * j] =
            to_f32(from_f32<T>(e));
      }
      l[i] = alpha * l[i] + row_sum(p_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[OPT];
#pragma unroll
      for (int c = 0; c < OPT; ++c) vv[c] = vs[j * D + tx + COL_LANES * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pp = ps[(ty * RPT + i) * BKP + j];
#pragma unroll
        for (int c = 0; c < OPT; ++c) acc[i][c] = fmaf(pp, vv[c], acc[i][c]);
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= p.s_q) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const int64_t base =
        ((static_cast<int64_t>(b) * p.s_q + row) * p.n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < OPT; ++c)
      out[base + tx + COL_LANES * c] = from_f32<T>(acc[i][c] / l_safe);
    if (tx == 0)
      p.lse[static_cast<int64_t>(bh) * p.s_q + row] =
          l[i] == 0.f ? NEG_INF : m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int bn, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(bn, (p.s_q + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int bn, int head_dim,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, bn, stream);
    case 32: return launch<T, 32>(p, bn, stream);
    case 64: return launch<T, 64>(p, bn, stream);
    case 128: return launch<T, 128>(p, bn, stream);
    case 256: return launch<T, 256>(p, bn, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns cudaSuccess (0) or the launch's cudaError_t.  is_bf16 selects
// __nv_bfloat16 for q, k, v and out; otherwise all are float.
int tf_flash_fwd(const void* q, const void* k, const void* v,
                 const void* mask, void* out, void* lse, int batch,
                 int n_heads, int s_q, int s_kv, int head_dim, int is_bf16,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                 int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                 int64_t v_sh, float scale, int causal, void* stream) {
  if (s_q <= 0 || s_kv <= 0 || batch <= 0 || n_heads <= 0)
    return cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const int32_t*>(mask), out,
           static_cast<float*>(lse), n_heads, s_q, s_kv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           scale, causal};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bn = batch * n_heads;
  return is_bf16 ? dispatch<__nv_bfloat16>(p, bn, head_dim, st)
                 : dispatch<float>(p, bn, head_dim, st);
}

const char* tf_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
