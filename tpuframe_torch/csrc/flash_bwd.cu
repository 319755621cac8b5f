// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// two kernels, one for dq and one for dk and dv, each in two routes, and
// the delta pass that runs before them.
//
// Replaces the TPU kernels tpuframe/ops/flash_attention.py:_bwd_dq_kernel
// and _bwd_dkv_kernel (their pallas_calls in _flash_bwd), with the
// probability recompute of _recompute_p.  Both compute the same function
// as there: p = keep ? exp(q.k * scale - lse) : 0 from the forward's saved
// logsumexp, dp = dO.v, ds = p * (dp - delta), and
//   dq = scale * ds.k,   dk = scale * ds^T.q,   dv = p^T.dO,
// with f32 accumulators.  As on the TPU, P is rounded to dO's type before
// the p^T.dO product and ds to q's (k's) type before its product, and a
// masked pair gets an explicit zero before any exponential: a fully masked
// row has lse = -1e30, so exp(s - lse) would be inf; its dq, and what it
// gives dk and dv, are exactly 0.
//
// delta.  The TPU kernels take delta = rowsum(dO * O), computed outside
// from the forward's output rounded to its dtype.  Here the delta pass
// computes it from the very p and dp the two kernels use:
//   delta = sum_j p * dp / sum_j p,
// so ds = p * (dp - delta) sums to zero over each row.  Where dp - delta
// is small against dp (BERT's upper layers, whose query and key gradients
// are ~1e-3 of the value gradients at init), any error in delta is a
// per-row offset that ds carries into every key: the rounded O's error in
// rowsum(dO * O) outweighed those gradients in bf16, and a plain f32 sum
// of p * dp over the row cost them ~1e-4 in f32.  So the pass sums in f32
// only over one key tile (a thread's share of it) and adds those partial
// sums in f64.  On the tensor cores the pass is a kernel of its own,
// flash_bwd_delta_tc_kernel (its note below says what bounds it); on the
// CUDA cores it is the dq kernel in a mode that skips its third product.
// The lse cotangent (flash_mha_lse) is folded in outside, in PyTorch.
//
// The FA2 split keeps the backward free of atomics and deterministic: the
// dq kernel owns a tile of query rows and loops over key tiles (stopping
// at the diagonal under `causal`); the dkv kernel owns a tile of keys and
// loops over query tiles (starting at the diagonal).  Each recomputes the
// scores it needs, so nothing S x S reaches device memory.  The TPU's
// sequential grid axis becomes that loop inside one thread block.
//
// What bounds it on the H100: operations.  Per kept query-key pair and
// head, dq does three products of D multiply-adds (q.k, dO.v, ds.k) and
// dkv four (k.q, v.dO, p^T.dO, ds^T.q): 7*D multiply-adds in all.  At the
// training slice's shapes (B=8, S=4096, 12 heads of 64, bf16, causal) that
// is 7.2e11 FLOPs a layer, 0.73 ms at the tensor cores' 989 TFLOP/s,
// against 0.17 ms to move the 560 MB the pair reads and writes.
//
// Tensor-core route (bf16, D = 64 or 128): the seven products are wgmma
// (bf16 x bf16 -> f32) issued by one warpgroup, a block of four warps
// that owns a 64-row tile (query rows in dq, keys in dkv) against a
// streamed tile (64 keys in dq; 64 queries in dkv at D=64, 32 at D=128,
// so that dk and dv, 2 x D/2 f32 registers a thread, leave room for the
// scores).  The score products read both operands from shared memory
// through descriptors; dS and P^T then stay in registers: the
// accumulator of a score product, rounded to bf16 in pairs, is exactly
// the register A operand of the next product, so they never touch shared
// memory.  That product's B (k in dq, q and dO in dkv) is the same tile
// the score product read K-major, now read MN-major, so nothing is
// transposed in memory.  Tiles are bf16 in wgmma's 128-byte swizzle
// (rows of 64 values, 16-byte chunks XORed with the row within each
// 1024-byte atom, so reads hit every bank) and loaded with 16-byte
// cp.async in two stages (zero-filled past S): the next tile loads while
// this one computes.  At D=64 the target is three blocks an SM (12
// warps), so that one block's loads, exponentials and barriers overlap
// another's products; at D=128 the dk and dv accumulators alone are 128
// f32 a thread and two blocks fit.  Under `causal` the dq kernel's grid
// runs its last query tiles, which have the most key tiles, first.  Each
// product group is waited for before its result is used; overlapping one
// tile's products with the next tile's exponentials (two warpgroups, or
// a producer warp with TMA) is the next step.
//
// CUDA-core route (f32 at every head dim, bf16 at D = 16, 32, 256): the
// products are FMAs, each tile staged in shared memory as f32, rows padded
// by one word so that the 16 lanes sharing a row hit 16 banks.  f32 stays
// here on purpose: a single TF32 pass keeps about 3 decimal digits, and
// f32 gradients are held to 1e-4.
//
// Tiles wholly masked by causality are never loaded, and the ragged edge
// is masked in both routes, so any S works.
//
// Layout: q, k, v, dout are [B, S, N, D] with unit stride on D and any
// other strides (in elements; multiples of 8, on 16-byte aligned data, in
// the tensor-core route); lse and delta are contiguous [B, N, S_q] f32; dq
// is a fresh contiguous [B, S_q, N, D], dk and dv fresh contiguous
// [B, S_kv, N, D].  mask, when given, is [B, S_kv] int32, nonzero =
// attend.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_tiles.cuh"

namespace {

constexpr int ROW_GROUPS = 8;               // thread rows
constexpr int COL_LANES = 16;               // threads that share a row
constexpr int NT = ROW_GROUPS * COL_LANES;  // 128 threads
constexpr int RPT = 4;                      // owned rows per thread
constexpr int BR = ROW_GROUPS * RPT;        // 32 rows a block owns
constexpr int BC = 64;                      // rows of each streamed tile
constexpr int CPT = BC / COL_LANES;         // streamed rows per thread
constexpr int BCP = BC + 1;                 // padded smem row of P / dS

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int32_t* mask;
  void* dq;
  void* dk;
  void* dv;
  float* delta_out;  // the delta pass's [B, N, S_q] f32 output
  int n_heads, s_q, s_kv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh;
  float scale;
  int causal;
};

// Which kernel a launch runs.
enum Mode { DKV = 0, DQ = 1, DELTA = 2 };

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

// x rounded to T and widened back: the operand rounding the TPU kernel
// does with .astype before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Rows r0 .. r0+R-1 of a [S, D] slice (row stride in elements) into
// shared memory as f32 [R][D+1]; rows at or past n read as zero.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int r0, int n,
                                          int tid) {
  constexpr int DP = D + 1;
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * DP + c] =
        r0 + r < n ? to_f32(src[static_cast<int64_t>(r0 + r) * row_stride + c])
                   : 0.f;
  }
}

// acc[i][j] = a[row i] . b[row j] over D, for this thread's owned rows
// ty*RPT + i of `a` and streamed rows tx + 16*j of `b` (both [.][D+1]).
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx,
                                         float (&acc)[RPT][CPT]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[RPT], y[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) x[i] = a[(ty * RPT + i) * DP + d];
#pragma unroll
    for (int j = 0; j < CPT; ++j) y[j] = b[(tx + COL_LANES * j) * DP + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][c] += sum_j w[row i][j] * m[j][col c] over the BC streamed rows,
// for owned rows ty*RPT + i and head dims tx + 16*c (w is [BR][BC+1], m is
// [BC][D+1]).
template <int D>
__device__ __forceinline__ void tile_acc(const float* w, const float* m,
                                         int ty, int tx,
                                         float (&acc)[RPT][D / COL_LANES]) {
  constexpr int DP = D + 1;
  constexpr int OPT = D / COL_LANES;
#pragma unroll 4
  for (int j = 0; j < BC; ++j) {
    float mm[OPT];
#pragma unroll
    for (int c = 0; c < OPT; ++c) mm[c] = m[j * DP + tx + COL_LANES * c];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float ww = w[(ty * RPT + i) * BCP + j];
#pragma unroll
      for (int c = 0; c < OPT; ++c) acc[i][c] = fmaf(ww, mm[c], acc[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * BR * (D + 1) + 2 * BC * (D + 1) + BR * BCP);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (2 * BR * (D + 1) + 2 * BC * (D + 1) + 2 * BR * BCP + 2 * BC);
}

// One block per (batch * head, tile of BR query rows); loops over key
// tiles.  Thread (ty, tx) owns query rows ty*RPT .. ty*RPT+RPT-1; for the
// scores it takes keys tx + 16*j of each tile, for dq head dims tx + 16*c.
// With DELTA_PASS it sums p * dp and p over each row instead of the dS.k
// product and writes delta: in f32 over a thread's four keys of a tile,
// then in f64, as the tensor-core delta kernel does.
template <typename T, int D, bool DELTA_PASS>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int OPT = D / COL_LANES;
  extern __shared__ float smem[];
  float* qs = smem;              // [BR][DP]
  float* dos = qs + BR * DP;     // [BR][DP]
  float* ks = dos + BR * DP;     // [BC][DP]
  float* vs = ks + BC * DP;      // [BC][DP]
  float* dss = vs + BC * DP;     // [BR][BCP]

  const int tid = threadIdx.x;
  const int ty = tid / COL_LANES, tx = tid % COL_LANES;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads, h = bh % p.n_heads;
  const int q0 = blockIdx.y * BR;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const int32_t* mask =
      p.mask != nullptr ? p.mask + static_cast<int64_t>(b) * p.s_kv : nullptr;

  load_tile<T, D, BR>(qs, q, p.q_ss, q0, p.s_q, tid);
  load_tile<T, D, BR>(dos, dout, p.o_ss, q0, p.s_q, tid);

  float lse[RPT], delta[RPT], acc[RPT][OPT];
  double pdp[RPT], psum[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    const int64_t at = static_cast<int64_t>(bh) * p.s_q + row;
    lse[i] = row < p.s_q ? p.lse[at] : 0.f;
    delta[i] = !DELTA_PASS && row < p.s_q ? p.delta[at] : 0.f;
    pdp[i] = psum[i] = 0.0;
#pragma unroll
    for (int c = 0; c < OPT; ++c) acc[i][c] = 0.f;
  }

  // Under `causal`, key tiles that start past this block's last row lie
  // wholly above the diagonal and are skipped.
  const int kv_end = p.causal ? min(p.s_kv, q0 + BR) : p.s_kv;
  for (int k0 = 0; k0 < kv_end; k0 += BC) {
    __syncthreads();  // the last tile's K and dS are no longer read
    load_tile<T, D, BC>(ks, k, p.k_ss, k0, p.s_kv, tid);
    load_tile<T, D, BC>(vs, v, p.v_ss, k0, p.s_kv, tid);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
    tile_dot<D>(qs, ks, ty, tx, s);
    tile_dot<D>(dos, vs, ty, tx, dp);

    bool key_ok[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = k0 + tx + COL_LANES * j;
      key_ok[j] = col < p.s_kv && (mask == nullptr || mask[col] != 0);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      float tp = 0.f, ts = 0.f;  // the delta pass's f32 sums over the tile
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + COL_LANES * j;
        const bool keep = key_ok[j] && (!p.causal || row >= col);
        // Explicit zero first: exp(s - lse) overflows on a masked row.
        const float pij = keep ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        if constexpr (DELTA_PASS) {
          tp = fmaf(pij, dp[i][j], tp);
          ts += pij;
        } else {
          dss[(ty * RPT + i) * BCP + tx + COL_LANES * j] =
              round_to<T>(pij * (dp[i][j] - delta[i]));
        }
      }
      if constexpr (DELTA_PASS) {
        pdp[i] += tp;
        psum[i] += ts;
      }
    }
    if constexpr (!DELTA_PASS) {
      __syncthreads();
      tile_acc<D>(dss, ks, ty, tx, acc);
    }
  }

  if constexpr (DELTA_PASS) {
    // The 16 lanes that share a row are one half of a warp.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int off = COL_LANES / 2; off > 0; off /= 2) {
        pdp[i] += __shfl_xor_sync(0xffffffffu, pdp[i], off);
        psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], off);
      }
      const int row = q0 + ty * RPT + i;
      if (tx == 0 && row < p.s_q)
        p.delta_out[static_cast<int64_t>(bh) * p.s_q + row] =
            psum[i] > 0.0 ? static_cast<float>(pdp[i] / psum[i]) : 0.f;
    }
    return;
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= p.s_q) continue;
    const int64_t base =
        ((static_cast<int64_t>(b) * p.s_q + row) * p.n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < OPT; ++c)
      dq[base + tx + COL_LANES * c] = from_f32<T>(acc[i][c] * p.scale);
  }
}

// One block per (batch * head, tile of BR keys); loops over query tiles.
// Thread (ty, tx) owns keys ty*RPT .. ty*RPT+RPT-1; for the transposed
// scores it takes queries tx + 16*j of each tile, for dk and dv head dims
// tx + 16*c.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int OPT = D / COL_LANES;
  extern __shared__ float smem[];
  float* ks = smem;              // [BR][DP]
  float* vs = ks + BR * DP;      // [BR][DP]
  float* qs = vs + BR * DP;      // [BC][DP]
  float* dos = qs + BC * DP;     // [BC][DP]
  float* pts = dos + BC * DP;    // [BR][BCP]  P^T, rounded to dO's type
  float* dsts = pts + BR * BCP;  // [BR][BCP]  dS^T, rounded to q's type
  float* lse_s = dsts + BR * BCP;  // [BC]
  float* delta_s = lse_s + BC;     // [BC]

  const int tid = threadIdx.x;
  const int ty = tid / COL_LANES, tx = tid % COL_LANES;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads, h = bh % p.n_heads;
  const int k0 = blockIdx.y * BR;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse = p.lse + static_cast<int64_t>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<int64_t>(bh) * p.s_q;
  const int32_t* mask =
      p.mask != nullptr ? p.mask + static_cast<int64_t>(b) * p.s_kv : nullptr;

  load_tile<T, D, BR>(ks, k, p.k_ss, k0, p.s_kv, tid);
  load_tile<T, D, BR>(vs, v, p.v_ss, k0, p.s_kv, tid);

  bool key_ok[RPT];
  float dk[RPT][OPT], dv[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + ty * RPT + i;
    key_ok[i] = key < p.s_kv && (mask == nullptr || mask[key] != 0);
#pragma unroll
    for (int c = 0; c < OPT; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  // Under `causal`, query tiles that end before this block's first key
  // lie wholly above the diagonal and are skipped.
  const int q_begin = p.causal ? (k0 / BC) * BC : 0;
  for (int q0 = q_begin; q0 < p.s_q; q0 += BC) {
    __syncthreads();  // the last tile's Q, dO, P^T and dS^T are not read
    load_tile<T, D, BC>(qs, q, p.q_ss, q0, p.s_q, tid);
    load_tile<T, D, BC>(dos, dout, p.o_ss, q0, p.s_q, tid);
    for (int i = tid; i < BC; i += NT) {
      const bool in = q0 + i < p.s_q;
      lse_s[i] = in ? lse[q0 + i] : 0.f;
      delta_s[i] = in ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
    tile_dot<D>(ks, qs, ty, tx, s);    // s[i][j]  = k_i . q_j
    tile_dot<D>(vs, dos, ty, tx, dp);  // dp[i][j] = v_i . dO_j

#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int row = q0 + tx + COL_LANES * j;  // query
      const bool row_ok = row < p.s_q;
      const float lse_j = lse_s[tx + COL_LANES * j];
      const float delta_j = delta_s[tx + COL_LANES * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int key = k0 + ty * RPT + i;
        const bool keep = key_ok[i] && row_ok && (!p.causal || row >= key);
        // Explicit zero first: exp(s - lse) overflows on a masked row.
        const float pij = keep ? expf(s[i][j] * p.scale - lse_j) : 0.f;
        const int at = (ty * RPT + i) * BCP + tx + COL_LANES * j;
        pts[at] = round_to<T>(pij);
        dsts[at] = round_to<T>(pij * (dp[i][j] - delta_j));
      }
    }
    __syncthreads();
    tile_acc<D>(pts, dos, ty, tx, dv);
    tile_acc<D>(dsts, qs, ty, tx, dk);
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + ty * RPT + i;
    if (key >= p.s_kv) continue;
    const int64_t base =
        ((static_cast<int64_t>(b) * p.s_kv + key) * p.n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < OPT; ++c) {
      dk_out[base + tx + COL_LANES * c] = from_f32<T>(dk[i][c] * p.scale);
      dv_out[base + tx + COL_LANES * c] = from_f32<T>(dv[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route: bf16, D = 64 or 128.

constexpr int TC_ROWS = 64;          // rows a block owns: 16 per warp
constexpr float LOG2E = 1.4426950408889634f;

// s = rows . tile^T and dp = rows2 . tile2^T over D: the two score
// products of the block's 64 owned rows against the NS rows of a streamed
// tile, every operand read from shared memory.
template <int D, int NS>
__device__ __forceinline__ void tc_scores(float (&s)[NS / 8][4],
                                          float (&dp)[NS / 8][4],
                                          const bf16* rows, const bf16* rows2,
                                          const bf16* tile,
                                          const bf16* tile2) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss(s, tc_desc_k<TC_ROWS>(rows, kk), tc_desc_k<NS>(tile, kk),
             kk > 0);
    wgmma_ss(dp, tc_desc_k<TC_ROWS>(rows2, kk), tc_desc_k<NS>(tile2, kk),
             kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// acc += w . tile: w is the 64 x NS accumulator of a score product
// (rounded to bf16 here, which is where the TPU kernel rounds it), the A
// operand from registers; tile, [NS][D] in shared memory, is B read
// MN-major, so nothing is transposed.
template <int D, int NS>
__device__ __forceinline__ void tc_acc(float (&acc)[D / 8][4],
                                       const float (&w)[NS / 8][4],
                                       const bf16* tile) {
  uint32_t a[NS / 16][4];
#pragma unroll
  for (int j = 0; j < NS / 16; ++j) {
    a[j][0] = pack_bf16(w[2 * j][0], w[2 * j][1]);
    a[j][1] = pack_bf16(w[2 * j][2], w[2 * j][3]);
    a[j][2] = pack_bf16(w[2 * j + 1][0], w[2 * j + 1][1]);
    a[j][3] = pack_bf16(w[2 * j + 1][2], w[2 * j + 1][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NS / 16; ++j) wgmma_rs(acc, a[j], tc_desc_mn<NS>(tile, j));
  wgmma_commit();
  wgmma_wait<0>();
}

// A warp's 16 x D accumulator, times `scale`, to rows r0 and r0+8 of a
// fresh [B, S, N, D] output (rows at or past n are not written).
template <int D>
__device__ __forceinline__ void tc_store(bf16* out, const float (&acc)[D / 8][4],
                                         float scale, int b, int h,
                                         int n_heads, int s, int r0, int n,
                                         int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + half * 8;
    if (row >= n) continue;
    bf16* dst = out + ((static_cast<int64_t>(b) * s + row) * n_heads + h) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[nt][2 * half] * scale,
                                acc[nt][2 * half + 1] * scale);
  }
}

// Rows of the streamed tile: keys in dq, queries in dkv.
constexpr int TC_DQ_COLS = 64;
template <int D>
__host__ __device__ constexpr int tc_dkv_cols() { return D == 64 ? 64 : 32; }

template <int D>
constexpr size_t tc_dq_smem_bytes() {
  return sizeof(bf16) * (2 * TC_ROWS + 4 * TC_DQ_COLS) * D +
         sizeof(int32_t) * 2 * TC_DQ_COLS + TC_ALIGN;
}

template <int D>
constexpr size_t tc_dkv_smem_bytes() {
  return sizeof(bf16) * (2 * TC_ROWS + 4 * tc_dkv_cols<D>()) * D +
         sizeof(float) * 4 * tc_dkv_cols<D>() + TC_ALIGN;
}

// One block per (batch * head, tile of 64 query rows), warp w owning rows
// 16w .. 16w+15; loops over tiles of 64 keys, two stages deep.
//
// Both tensor-core kernels ask for three blocks an SM at D=64, which caps
// them at 168 registers a thread; at D=128 the accumulators need the
// registers, so they take what they need and two blocks fit.
template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 3 : 1)
    flash_bwd_dq_tc_kernel(Params p) {
  constexpr int BK = TC_DQ_COLS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = tc_smem_base(tc_smem);  // [TC_ROWS][D], swizzled
  bf16* dos = qs + TC_ROWS * D;      // [TC_ROWS][D]
  bf16* ks = dos + TC_ROWS * D;      // [2][BK][D]
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
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + b * p.o_sb + h * p.o_sh;
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
  tc_load_tile<D, TC_ROWS>(qs, q, p.q_ss, q0, p.s_q, tid);
  tc_load_tile<D, TC_ROWS>(dos, dout, p.o_ss, q0, p.s_q, tid);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  // This thread's two rows of the warp's 16: r_lo and r_lo + 8.
  const int r_lo = q0 + warp * 16 + g;
  float lse2[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r_lo + half * 8;
    const int64_t at = static_cast<int64_t>(bh) * p.s_q + row;
    lse2[half] = row < p.s_q ? p.lse[at] * LOG2E : 0.f;
    delta[half] = row < p.s_q ? p.delta[at] : 0.f;
  }
  const float scale2 = p.scale * LOG2E;

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

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
    const int stage = t & 1, k0 = t * BK;
    const bf16* kt = ks + stage * BK * D;
    const bf16* vt = vs + stage * BK * D;
    const int32_t* mt = mask_s + stage * BK;

    float s[BK / 8][4], dp[BK / 8][4];
    tc_scores<D, BK>(s, dp, qs, dos, kt, vt);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, c = j * 8 + tig * 2 + (e & 1);
        const int row = r_lo + half * 8, col = k0 + c;
        const bool keep = col < p.s_kv && (mask == nullptr || mt[c] != 0) &&
                          (!p.causal || row >= col);
        // Explicit zero first: exp(s - lse) overflows on a masked row.
        const float pij =
            keep ? exp2f(fmaf(s[j][e], scale2, -lse2[half])) : 0.f;
        s[j][e] = pij * (dp[j][e] - delta[half]);  // ds
      }
    tc_acc<D, BK>(acc, s, kt);
    __syncthreads();  // this stage is reloaded two tiles on
  }
  cp_async_wait<0>();
  tc_store<D>(static_cast<bf16*>(p.dq), acc, p.scale, b, h, p.n_heads, p.s_q,
              r_lo, p.s_q, lane);
}

// 2^x on the MUFU, a result below 2^-126 flushed to zero: the probability
// of a pair that weighs nothing in delta.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Warpgroups of the delta kernel: two at D=64, each owning 64 query rows
// of the block's 128 against the same key tiles; one at D=128, where two
// would leave one block an SM.
template <int D>
__host__ __device__ constexpr int tc_delta_wgs() { return D == 64 ? 2 : 1; }

template <int D>
constexpr size_t tc_delta_smem_bytes() {
  return sizeof(bf16) * (2 * tc_delta_wgs<D>() * TC_ROWS + 4 * TC_DQ_COLS) *
             D +
         sizeof(int32_t) * 2 * TC_DQ_COLS + TC_ALIGN;
}

// The delta pass on the tensor cores: the dq kernel's two score products
// a tile, without its third product or its accumulator.  Per kept pair it
// does one FMA, one exp2 on the MUFU (16 a clock an SM: as fast, for a
// D=64 pair, as the pair's two products on the tensor cores), one FMA and
// one add.  Run as the dq kernel in a mode that added each pair in f64
// (two conversions to f64, at 16 a clock an SM, and two f64 ops a pair),
// the pass took 1.8 ms a layer at the LM's shape, 8.7x its bound.  So:
//   - the sums of p * dp and p run in f32 over the 16 values each of this
//     thread's two rows takes from one key tile, and only those partial
//     sums are added into the f64 row sums: four conversions a thread a
//     tile, not two a pair.  An f32 sum over one tile rounds at one tile's
//     magnitude; a serial f32 sum over the whole row would round at the
//     row's at every key;
//   - tiles that need no mask (below the causal diagonal, inside S_kv, no
//     key mask) skip the per-pair keep test, and exp2 flushes results
//     below 2^-126 to zero (ex2.approx.ftz), which saves its range fix-up;
//   - at D=64 a block is two warpgroups, 128 query rows, that share each
//     K and V tile, and with no accumulator two such blocks (16 warps) fit
//     an SM.
// What bounds it now is no single unit: measured at the LM's shape (PERF.md
// §6), it runs at a third of its tensor-core bound, it is only 7% faster
// with its exponentials removed, no faster with a third load stage, and
// slower with Q and dO as register operands or with the next tile's
// products issued before this tile's arithmetic in one warpgroup.  Each
// warpgroup waits for its products before its arithmetic; overlapping the
// two across warpgroups (FA3's ping-pong) is what is left.
template <int D>
__global__ void __launch_bounds__(NT * tc_delta_wgs<D>(), 2)
    flash_bwd_delta_tc_kernel(Params p) {
  constexpr int BK = TC_DQ_COLS, WG = tc_delta_wgs<D>();
  constexpr int THREADS = WG * NT, ROWS = WG * TC_ROWS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = tc_smem_base(tc_smem);  // [WG][TC_ROWS][D], swizzled
  bf16* dos = qs + ROWS * D;         // [WG][TC_ROWS][D]
  bf16* ks = dos + ROWS * D;         // [2][BK][D]
  bf16* vs = ks + 2 * BK * D;        // [2][BK][D]
  int32_t* mask_s = reinterpret_cast<int32_t*>(vs + 2 * BK * D);  // [2][BK]

  const int tid = threadIdx.x, wg = tid / NT, warp = (tid % NT) >> 5;
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads, h = bh % p.n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // heaviest first
  const int qw = q0 + wg * TC_ROWS;  // this warpgroup's first row
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const int32_t* mask =
      p.mask != nullptr ? p.mask + static_cast<int64_t>(b) * p.s_kv : nullptr;

  // Under `causal` the block stops at its last row's diagonal tile, and a
  // warpgroup skips the tiles past its own.
  const int kv_end = p.causal ? min(p.s_kv, q0 + ROWS) : p.s_kv;
  const int wg_end = p.causal ? min(p.s_kv, qw + TC_ROWS) : p.s_kv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  auto load_kv = [&](int t) {
    const int stage = t & 1;
    tc_load_tile<D, BK, THREADS>(ks + stage * BK * D, k, p.k_ss, t * BK,
                                 p.s_kv, tid);
    tc_load_tile<D, BK, THREADS>(vs + stage * BK * D, v, p.v_ss, t * BK,
                                 p.s_kv, tid);
    if (mask != nullptr && tid < BK) {
      const int col = t * BK + tid;
      cp_async4(mask_s + stage * BK + tid, col < p.s_kv ? mask + col : mask,
                col < p.s_kv);
    }
  };
#pragma unroll
  for (int w = 0; w < WG; ++w) {
    tc_load_tile<D, TC_ROWS, THREADS>(qs + w * TC_ROWS * D, q, p.q_ss,
                                      q0 + w * TC_ROWS, p.s_q, tid);
    tc_load_tile<D, TC_ROWS, THREADS>(dos + w * TC_ROWS * D, dout, p.o_ss,
                                      q0 + w * TC_ROWS, p.s_q, tid);
  }
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  // This thread's two rows of its warp's 16: r_lo and r_lo + 8.
  const int r_lo = qw + warp * 16 + g;
  const bf16* qw_s = qs + wg * TC_ROWS * D;
  const bf16* dow_s = dos + wg * TC_ROWS * D;
  float lse2[2];
  double pdp[2] = {0.0, 0.0}, psum[2] = {0.0, 0.0};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r_lo + half * 8;
    lse2[half] =
        row < p.s_q ? p.lse[static_cast<int64_t>(bh) * p.s_q + row] * LOG2E
                    : 0.f;
  }
  const float scale2 = p.scale * LOG2E;

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
    const int stage = t & 1, k0 = t * BK;
    if (k0 < wg_end) {  // the same for the whole warpgroup
      const int32_t* mt = mask_s + stage * BK;
      float s[BK / 8][4], dp[BK / 8][4];
      tc_scores<D, BK>(s, dp, qw_s, dow_s, ks + stage * BK * D,
                       vs + stage * BK * D);
      // This tile's f32 sums of p * dp and p for each of the two rows.
      float tp[2] = {0.f, 0.f}, ts[2] = {0.f, 0.f};
      auto add_pairs = [&](auto check) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int half = e >> 1;
            float pij = exp2_ftz(fmaf(s[j][e], scale2, -lse2[half]));
            if constexpr (decltype(check)::value) {
              const int c = j * 8 + tig * 2 + (e & 1);
              const int row = r_lo + half * 8, col = k0 + c;
              // A select, not a product: a masked row's exponential is inf.
              pij = col < p.s_kv && (mask == nullptr || mt[c] != 0) &&
                            (!p.causal || row >= col)
                        ? pij
                        : 0.f;
            }
            tp[half] = fmaf(pij, dp[j][e], tp[half]);
            ts[half] += pij;
          }
      };
      if (mask == nullptr && k0 + BK <= p.s_kv && (!p.causal || k0 < qw))
        add_pairs(std::false_type{});
      else
        add_pairs(std::true_type{});
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        pdp[half] += tp[half];
        psum[half] += ts[half];
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }
  cp_async_wait<0>();
  // A row's columns lie in the four lanes of one quad.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      pdp[half] += __shfl_xor_sync(0xffffffffu, pdp[half], off);
      psum[half] += __shfl_xor_sync(0xffffffffu, psum[half], off);
    }
    const int row = r_lo + half * 8;
    if (tig == 0 && row < p.s_q)
      p.delta_out[static_cast<int64_t>(bh) * p.s_q + row] =
          psum[half] > 0.0 ? static_cast<float>(pdp[half] / psum[half]) : 0.f;
  }
}

// One block per (batch * head, tile of 64 keys), warp w owning keys
// 16w .. 16w+15; loops over tiles of BQ queries (with their lse and delta
// rows), two stages deep.
template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 3 : 1)
    flash_bwd_dkv_tc_kernel(Params p) {
  constexpr int BQ = tc_dkv_cols<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = tc_smem_base(tc_smem);  // [TC_ROWS][D], swizzled
  bf16* vs = ks + TC_ROWS * D;       // [TC_ROWS][D]
  bf16* qs = vs + TC_ROWS * D;       // [2][BQ][D]
  bf16* dos = qs + 2 * BQ * D;       // [2][BQ][D]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * D);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                             // [2][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads, h = bh % p.n_heads;
  const int k0 = blockIdx.y * TC_ROWS;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse = p.lse + static_cast<int64_t>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<int64_t>(bh) * p.s_q;
  const int32_t* mask =
      p.mask != nullptr ? p.mask + static_cast<int64_t>(b) * p.s_kv : nullptr;

  // Under `causal`, queries before this block's first key lie wholly
  // above the diagonal and are skipped.
  const int q_begin = p.causal ? k0 : 0;
  const int n_tiles = q_begin < p.s_q ? (p.s_q - q_begin + BQ - 1) / BQ : 0;
  auto load_q = [&](int t) {
    const int stage = t & 1, r0 = q_begin + t * BQ;
    tc_load_tile<D, BQ>(qs + stage * BQ * D, q, p.q_ss, r0, p.s_q, tid);
    tc_load_tile<D, BQ>(dos + stage * BQ * D, dout, p.o_ss, r0, p.s_q, tid);
    if (tid < BQ) {
      const bool ok = r0 + tid < p.s_q;
      cp_async4(lse_s + stage * BQ + tid, ok ? lse + r0 + tid : lse, ok);
      cp_async4(delta_s + stage * BQ + tid, ok ? delta + r0 + tid : delta,
                ok);
    }
  };
  tc_load_tile<D, TC_ROWS>(ks, k, p.k_ss, k0, p.s_kv, tid);
  tc_load_tile<D, TC_ROWS>(vs, v, p.v_ss, k0, p.s_kv, tid);
  if (n_tiles > 0) load_q(0);
  cp_async_commit();

  // This thread's two keys of the warp's 16: key_lo and key_lo + 8.
  const int key_lo = k0 + warp * 16 + g;
  bool key_ok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_lo + half * 8;
    key_ok[half] = key < p.s_kv && (mask == nullptr || mask[key] != 0);
  }
  const float scale2 = p.scale * LOG2E;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_q(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();  // the tiles that arrived are read by wgmma
    __syncthreads();
    const int stage = t & 1, qt0 = q_begin + t * BQ;
    const bf16* qt = qs + stage * BQ * D;
    const bf16* ot = dos + stage * BQ * D;
    const float* lt = lse_s + stage * BQ;
    const float* dt = delta_s + stage * BQ;

    // st[j][e] = k_key . q_query, dpt[j][e] = v_key . dO_query
    float st[BQ / 8][4], dpt[BQ / 8][4];
    tc_scores<D, BQ>(st, dpt, ks, vs, qt, ot);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = j * 8 + tig * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int query = qt0 + c + (e & 1), key = key_lo + half * 8;
        const bool keep = key_ok[half] && query < p.s_q &&
                          (!p.causal || query >= key);
        const float lq = (e & 1) ? l2.y : l2.x;
        const float dq_ = (e & 1) ? d2.y : d2.x;
        // Explicit zero first: exp(s - lse) overflows on a masked row.
        const float pij =
            keep ? exp2f(fmaf(st[j][e], scale2, -lq * LOG2E)) : 0.f;
        st[j][e] = pij;                       // P^T
        dpt[j][e] = pij * (dpt[j][e] - dq_);  // dS^T
      }
    }
    tc_acc<D, BQ>(dv, st, ot);
    tc_acc<D, BQ>(dk, dpt, qt);
    __syncthreads();  // this stage is reloaded two tiles on
  }
  cp_async_wait<0>();
  tc_store<D>(static_cast<bf16*>(p.dk), dk, p.scale, b, h, p.n_heads,
              p.s_kv, key_lo, p.s_kv, lane);
  tc_store<D>(static_cast<bf16*>(p.dv), dv, 1.f, b, h, p.n_heads, p.s_kv,
              key_lo, p.s_kv, lane);
}

using KernelFn = void (*)(Params);

template <typename T, int D, typename F>
cudaError_t with_cuda_core(Mode mode, F&& f) {
  switch (mode) {
    case DQ: return f(flash_bwd_dq_kernel<T, D, false>, dq_smem_bytes<D>(),
                      BR, NT);
    case DELTA: return f(flash_bwd_dq_kernel<T, D, true>, dq_smem_bytes<D>(),
                         BR, NT);
    default: return f(flash_bwd_dkv_kernel<T, D>, dkv_smem_bytes<D>(), BR,
                      NT);
  }
}

template <int D, typename F>
cudaError_t with_tensor_core(Mode mode, F&& f) {
  switch (mode) {
    case DQ: return f(flash_bwd_dq_tc_kernel<D>, tc_dq_smem_bytes<D>(),
                      TC_ROWS, NT);
    case DELTA: return f(flash_bwd_delta_tc_kernel<D>,
                         tc_delta_smem_bytes<D>(),
                         TC_ROWS * tc_delta_wgs<D>(), NT * tc_delta_wgs<D>());
    default: return f(flash_bwd_dkv_tc_kernel<D>, tc_dkv_smem_bytes<D>(),
                      TC_ROWS, NT);
  }
}

// f(kernel, its dynamic shared memory bytes, the rows a block owns, its
// threads) for the kernel that serves (mode, head_dim, dtype, route).
template <typename F>
cudaError_t with_kernel(Mode mode, int head_dim, bool bf16, bool tensor_core,
                        F&& f) {
  if (tensor_core) {
    if (!bf16) return cudaErrorInvalidValue;
    switch (head_dim) {
      case 64: return with_tensor_core<64>(mode, f);
      case 128: return with_tensor_core<128>(mode, f);
      default: return cudaErrorInvalidValue;
    }
  }
  // bf16 at 64 and 128 runs on the tensor cores only.
  switch (head_dim) {
    case 16: return bf16 ? with_cuda_core<__nv_bfloat16, 16>(mode, f)
                         : with_cuda_core<float, 16>(mode, f);
    case 32: return bf16 ? with_cuda_core<__nv_bfloat16, 32>(mode, f)
                         : with_cuda_core<float, 32>(mode, f);
    case 64: return bf16 ? cudaErrorInvalidValue
                         : with_cuda_core<float, 64>(mode, f);
    case 128: return bf16 ? cudaErrorInvalidValue
                          : with_cuda_core<float, 128>(mode, f);
    case 256: return bf16 ? with_cuda_core<__nv_bfloat16, 256>(mode, f)
                          : with_cuda_core<float, 256>(mode, f);
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
bool tc_aligned(const Params& p, const int64_t* strides) {
  const void* ptrs[4] = {p.q, p.k, p.v, p.dout};
  for (const void* t : ptrs)
    if (reinterpret_cast<uintptr_t>(t) % 16 != 0) return false;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

int run(Mode mode, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta,
        const void* mask, void* dq_out, void* dk_out, void* dv_out,
        float* delta_out, int batch, int n_heads, int s_q, int s_kv,
        int head_dim, int is_bf16, const int64_t* strides, float scale,
        int causal, int tensor_core, void* stream) {
  if (s_q <= 0 || s_kv <= 0 || batch <= 0 || n_heads <= 0)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 static_cast<const int32_t*>(mask), dq_out, dk_out, dv_out,
                 delta_out, n_heads, s_q, s_kv,
                 strides[0], strides[1], strides[2], strides[3], strides[4],
                 strides[5], strides[6], strides[7], strides[8], strides[9],
                 strides[10], strides[11], scale, causal};
  if (tensor_core && !tc_aligned(p, strides))
    return cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_total = mode == DKV ? s_kv : s_q;
  return with_kernel(
      mode, head_dim, is_bf16 != 0, tensor_core != 0,
      [&](KernelFn kernel, size_t smem, int rows, int threads) {
        const cudaError_t err = allow_smem(kernel, smem);
        if (err != cudaSuccess) return err;
        const dim3 grid(batch * n_heads, (rows_total + rows - 1) / rows);
        kernel<<<grid, threads, smem, st>>>(p);
        return cudaGetLastError();
      });
}

}  // namespace

extern "C" {

// Each returns cudaSuccess (0) or the launch's cudaError_t.  is_bf16
// selects __nv_bfloat16 for q, k, v, dout and the gradients; otherwise all
// are float (lse, delta and the delta pass's output are float always).  strides holds the batch, sequence and head strides (in
// elements) of q, k, v and dout, in that order: 12 values.  tensor_core
// selects the tensor-core kernels (bf16, head_dim 64 or 128, strides that
// are multiples of 8 on 16-byte aligned data); otherwise the CUDA-core
// kernels run (f32, or bf16 at head_dim 16, 32, 256).
int tf_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* mask, void* dq, int batch, int n_heads,
                    int s_q, int s_kv, int head_dim, int is_bf16,
                    const int64_t* strides, float scale, int causal,
                    int tensor_core, void* stream) {
  return run(DQ, q, k, v, dout, lse, delta, mask, dq, nullptr, nullptr,
             nullptr, batch, n_heads, s_q, s_kv, head_dim, is_bf16, strides,
             scale, causal, tensor_core, stream);
}

int tf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* mask, void* dk, void* dv, int batch,
                     int n_heads, int s_q, int s_kv, int head_dim,
                     int is_bf16, const int64_t* strides, float scale,
                     int causal, int tensor_core, void* stream) {
  return run(DKV, q, k, v, dout, lse, delta, mask, nullptr, dk, dv, nullptr,
             batch, n_heads, s_q, s_kv, head_dim, is_bf16, strides, scale,
             causal, tensor_core, stream);
}

// The delta pass: delta [B, N, S_q] = sum_j p * dp / sum_j p over each
// query row (0 where the row keeps no key), before dq and dkv run.
int tf_flash_bwd_delta(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* mask,
                       float* delta, int batch, int n_heads, int s_q,
                       int s_kv, int head_dim, int is_bf16,
                       const int64_t* strides, float scale, int causal,
                       int tensor_core, void* stream) {
  return run(DELTA, q, k, v, dout, lse, nullptr, mask, nullptr, nullptr,
             nullptr, delta, batch, n_heads, s_q, s_kv, head_dim, is_bf16,
             strides, scale, causal, tensor_core, stream);
}

// The dynamic shared memory of the kernel that serves (mode: 0 dkv, 1 dq,
// 2 the delta pass; head_dim, dtype, route) and how many of its blocks an
// SM holds at once.
int tf_flash_bwd_kernel_info(int mode, int head_dim, int is_bf16,
                             int tensor_core, int* smem_bytes,
                             int* blocks_per_sm) {
  if (mode < DKV || mode > DELTA) return cudaErrorInvalidValue;
  return with_kernel(static_cast<Mode>(mode), head_dim, is_bf16 != 0,
                     tensor_core != 0,
                     [&](KernelFn kernel, size_t smem, int, int threads) {
                       *smem_bytes = static_cast<int>(smem);
                       const cudaError_t err = allow_smem(kernel, smem);
                       if (err != cudaSuccess) return err;
                       return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks_per_sm, kernel, threads, smem);
                     });
}

const char* tf_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
