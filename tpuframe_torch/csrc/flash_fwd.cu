// Flash-attention forward for Hopper (sm_90a), with a plain C interface,
// in two routes.
//
// Replaces the TPU kernel tpuframe/ops/flash_attention.py:_fwd_kernel
// (pallas_call in _flash_fwd).  It computes the same function: scores in
// f32 scaled by D**-0.5, an online softmax with a running max and
// normaliser, P rounded to V's type before the PV product, an f32
// accumulator, out written in q's type and the logsumexp in f32.  A row
// whose keys are all masked gives a zero output and lse = -1e30.  The
// S x S scores never leave the SM: the TPU's sequential grid axis over
// K/V blocks becomes a loop inside one thread block.  Tiles wholly above
// the diagonal are never loaded under `causal`, and the ragged edge is
// masked here, so any S works.
//
// What bounds it on the H100: operations.  Per kept query-key pair and
// head it does two products of D multiply-adds (q.k and p.v): at the
// training slice's shapes (B=8, S=4096, 12 heads of 64, bf16, causal)
// 2.06e11 FLOPs a layer, 0.21 ms at the tensor cores' 989 TFLOP/s,
// against 0.06 ms to move the 200 MB it reads and writes.  So the
// products must run on the tensor cores, beside the softmax's
// exponentials (one a pair, on the SFU).
//
// Tensor-core route (bf16, D = 64 or 128): one warpgroup, a block of four
// warps, owns 64 query rows (warp w rows 16w .. 16w+15) and loops over
// tiles of 64 keys.  S = Q.K^T is a wgmma reading both operands from
// 128-byte-swizzled shared memory, K-major.  The mask and online softmax
// run on the accumulator's layout: each thread holds rows g and g+8 of
// its warp, and a row's max is taken across the 4 lanes of a quad by
// shuffles; exponentials are exp2 with scale * log2(e) folded in.  P,
// rounded to bf16 in pairs, is the register A operand of O += P.V, with V
// read MN-major from the tile it was loaded into, so P never touches
// shared memory.  The row sum is kept per thread and reduced once at the
// end.  K and V stream through two cp.async stages (zero-filled past
// S_kv, the mask beside K), the next tile loading while this one
// computes.  Each product is waited for before its result is used; four
// blocks an SM at D=64 (two at D=128, where O alone is 64 f32 a thread)
// overlap one block's exponentials with another's products.  A version
// that overlapped them inside the block (tile t's scores issued with tile
// t-1's P.V, the softmax run under the P.V, P in two register sets) took
// 153 registers against 129, both three blocks an SM, and ran 4% slower
// on the H100 (PERF.md, PR 5), so it was not kept.  Under `causal` the grid runs its last query
// tiles, which see the most keys, first.
//
// CUDA-core route (f32 at every head dim, bf16 at D = 16, 32, 256): the
// two products are FMAs, each K/V tile staged in shared memory as f32
// (rows padded by one word so that no two lanes of a warp hit one bank).
//
// Layout: q, k, v are [B, S, N, D] with unit stride on D and any other
// strides (in elements; multiples of 8, on 16-byte aligned data, in the
// tensor-core route); out is a fresh contiguous [B, S_q, N, D] and lse a
// contiguous [B, N, S_q].  mask, when given, is [B, S_kv] int32,
// nonzero = attend.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tiles.cuh"

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

// ---------------------------------------------------------------------------
// Tensor-core route: bf16, D = 64 or 128.

constexpr int TC_ROWS = 64;  // query rows a block owns: 16 per warp
constexpr int TC_COLS = 64;  // keys a streamed tile holds
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (TC_ROWS + 4 * TC_COLS) * D +
         sizeof(int32_t) * 2 * TC_COLS + TC_ALIGN;
}

// Max and sum over the 4 lanes of a quad, which hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One block per (batch * head, tile of 64 query rows), warp w owning rows
// 16w .. 16w+15; loops over tiles of 64 keys, two stages deep.  At D=64
// it asks for four blocks an SM (at most 128 registers a thread): an
// earlier build at 129 registers held three and took 1.30 ms at the
// training shape against 1.13 (PERF.md, PR 5).
template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 4 : 2)
    flash_fwd_tc_kernel(Params p) {
  constexpr int BK = TC_COLS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = tc_smem_base(tc_smem);  // [TC_ROWS][D], swizzled
  bf16* ks = qs + TC_ROWS * D;       // [2][BK][D]
  bf16* vs = ks + 2 * BK * D;        // [2][BK][D]
  int32_t* mask_s = reinterpret_cast<int32_t*>(vs + 2 * BK * D);  // [2][BK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads, h = bh % p.n_heads;
  // Under `causal` the last query tiles see the most key tiles: launch
  // them first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int32_t* mask =
      p.mask != nullptr ? p.mask + static_cast<int64_t>(b) * p.s_kv : nullptr;

  const int kv_end = p.causal ? min(p.s_kv, q0 + TC_ROWS) : p.s_kv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  auto load_kv = [&](int t) {
    const int stage = t & 1;
    tc_load_tile<D, BK>(ks + stage * BK * D, k, p.k_ss, t * BK, p.s_kv, tid);
    tc_load_tile<D, BK>(vs + stage * BK * D, v, p.v_ss, t * BK, p.s_kv, tid);
    if (mask != nullptr && tid < BK) {
      const int col = t * BK + tid;
      cp_async4(mask_s + stage * BK + tid, col < p.s_kv ? mask + col : mask,
                col < p.s_kv);
    }
  };

  // This thread's two rows of the warp's 16: r_lo and r_lo + 8.
  const int r_lo = q0 + warp * 16 + g;
  const float scale2 = p.scale * LOG2E;
  float m2[2] = {NEG_INF, NEG_INF};  // running max, in log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the row sum
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  // The online softmax of tile t's scores s: updates m2 and l, returns
  // the rescale factor of each row's earlier sums in alpha, and P rounded
  // to bf16 in pa (the A fragments of the P.V product).
  auto softmax = [&](float (&s)[BK / 8][4], int t, float (&alpha)[2],
                     uint32_t (&pa)[BK / 16][4]) {
    const int k0 = t * BK;
    const int32_t* mt = mask_s + (t & 1) * BK;
    // Masking is needed on a tile that straddles the diagonal, passes the
    // ragged end or has a key mask: bit 4j+e of keep is entry (j, e).
    const bool need = mask != nullptr || k0 + BK > p.s_kv ||
                      (p.causal && k0 + BK - 1 > q0);
    uint32_t keep = 0xffffffffu;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, c = j * 8 + tig * 2 + (e & 1);
        const int row = r_lo + half * 8, col = k0 + c;
        if (need && !(col < p.s_kv && (mask == nullptr || mt[c] != 0) &&
                      (!p.causal || row >= col))) {
          keep &= ~(1u << (4 * j + e));
          s[j][e] = NEG_INF;
        } else {
          s[j][e] *= scale2;
        }
        mx[half] = fmaxf(mx[half], s[j][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new = fmaxf(m2[half], quad_max(mx[half]));
      alpha[half] = exp2f(m2[half] - m_new);
      m2[half] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Explicit zero (not exp underflow): a fully masked row keeps
        // l == 0 and finalises to a zero output.
        const float pij = (keep >> (4 * j + e)) & 1
                              ? exp2f(s[j][e] - m2[e >> 1])
                              : 0.f;
        sum[e >> 1] += pij;
        s[j][e] = pij;
      }
#pragma unroll
    for (int half = 0; half < 2; ++half)
      l[half] = alpha[half] * l[half] + sum[half];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
    }
  };

  tc_load_tile<D, TC_ROWS>(qs, q, p.q_ss, q0, p.s_q, tid);
  load_kv(0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();  // the tiles that arrived are read by wgmma
    __syncthreads();
    const bf16* kt = ks + (t & 1) * BK * D;
    const bf16* vt = vs + (t & 1) * BK * D;

    float s[BK / 8][4], alpha[2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, tc_desc_k<TC_ROWS>(qs, kk), tc_desc_k<BK>(kt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(s);

    uint32_t pa[BK / 16][4];
    softmax(s, t, alpha, pa);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) wgmma_rs(o, pa[j], tc_desc_mn<BK>(vt, j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(o);
    __syncthreads();  // this stage is reloaded two tiles on
  }

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float lsum = quad_sum(l[half]);
    const int row = r_lo + half * 8;
    if (row >= p.s_q) continue;
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    bf16* dst = out + ((static_cast<int64_t>(b) * p.s_q + row) * p.n_heads +
                       h) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8 + tig * 2) =
          __floats2bfloat162_rn(o[nt][2 * half] / l_safe,
                                o[nt][2 * half + 1] / l_safe);
    if (tig == 0)
      p.lse[static_cast<int64_t>(bh) * p.s_q + row] =
          lsum == 0.f ? NEG_INF : m2[half] * LN2 + logf(l_safe);
  }
}

using KernelFn = void (*)(Params);

// f(kernel, its dynamic shared memory bytes, the rows a block owns) for
// the kernel that serves (head_dim, dtype, route).  The CUDA-core kernel
// takes bf16 at every head dim, so the two routes can be compared on the
// same inputs; the wrapper picks the tensor cores for bf16 at 64 and 128.
template <typename F>
cudaError_t with_kernel(int head_dim, bool bf16_in, bool tensor_core,
                        F&& f) {
  if (tensor_core) {
    if (!bf16_in) return cudaErrorInvalidValue;
    switch (head_dim) {
      case 64: return f(flash_fwd_tc_kernel<64>, tc_smem_bytes<64>(), TC_ROWS);
      case 128:
        return f(flash_fwd_tc_kernel<128>, tc_smem_bytes<128>(), TC_ROWS);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (head_dim) {
#define TF_CASE(DIM)                                                     \
  case DIM:                                                              \
    return bf16_in ? f(flash_fwd_kernel<__nv_bfloat16, DIM>,             \
                       smem_bytes<DIM>(), BQ)                            \
                   : f(flash_fwd_kernel<float, DIM>, smem_bytes<DIM>(), BQ);
    TF_CASE(16)
    TF_CASE(32)
    TF_CASE(64)
    TF_CASE(128)
    TF_CASE(256)
#undef TF_CASE
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t allow_smem(KernelFn kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The tensor-core route's 16-byte copies need 16-byte aligned rows.
bool tc_aligned(const Params& p) {
  const void* ptrs[3] = {p.q, p.k, p.v};
  for (const void* t : ptrs)
    if (reinterpret_cast<uintptr_t>(t) % 16 != 0) return false;
  const int64_t strides[9] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss,
                              p.k_sh, p.v_sb, p.v_ss, p.v_sh};
  for (int64_t st : strides)
    if (st % 8 != 0) return false;
  return true;
}

}  // namespace

extern "C" {

// Returns cudaSuccess (0) or the launch's cudaError_t.  is_bf16 selects
// __nv_bfloat16 for q, k, v and out; otherwise all are float.
// tensor_core selects the tensor-core kernel (bf16, head_dim 64 or 128,
// strides that are multiples of 8 on 16-byte aligned data); otherwise the
// CUDA-core kernel runs (either dtype, every head_dim).
int tf_flash_fwd(const void* q, const void* k, const void* v,
                 const void* mask, void* out, void* lse, int batch,
                 int n_heads, int s_q, int s_kv, int head_dim, int is_bf16,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                 int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                 int64_t v_sh, float scale, int causal, int tensor_core,
                 void* stream) {
  if (s_q <= 0 || s_kv <= 0 || batch <= 0 || n_heads <= 0)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const int32_t*>(mask), out,
                 static_cast<float*>(lse), n_heads, s_q, s_kv,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 scale, causal};
  if (tensor_core && !tc_aligned(p)) return cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kernel(
      head_dim, is_bf16 != 0, tensor_core != 0,
      [&](KernelFn kernel, size_t smem, int rows) {
        const cudaError_t err = allow_smem(kernel, smem);
        if (err != cudaSuccess) return err;
        const dim3 grid(batch * n_heads, (s_q + rows - 1) / rows);
        kernel<<<grid, NT, smem, st>>>(p);
        return cudaGetLastError();
      });
}

// The dynamic shared memory of the kernel that serves (head_dim, dtype,
// route) and how many of its blocks an SM holds at once.
int tf_flash_fwd_kernel_info(int head_dim, int is_bf16, int tensor_core,
                             int* smem_bytes, int* blocks_per_sm) {
  return with_kernel(head_dim, is_bf16 != 0, tensor_core != 0,
                     [&](KernelFn kernel, size_t smem, int) {
                       *smem_bytes = static_cast<int>(smem);
                       const cudaError_t err = allow_smem(kernel, smem);
                       if (err != cudaSuccess) return err;
                       return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks_per_sm, kernel, NT, smem);
                     });
}

const char* tf_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
