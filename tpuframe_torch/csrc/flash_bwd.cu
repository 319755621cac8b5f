// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// two kernels, one for dq and one for dk and dv.
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
// gives dk and dv, are exactly 0.  delta = rowsum(dO * O) (minus the lse
// cotangent, for flash_mha_lse) is computed outside, in PyTorch.
//
// The FA2 split keeps the backward free of atomics and deterministic: the
// dq kernel owns a tile of query rows and loops over key tiles (stopping
// at the diagonal under `causal`); the dkv kernel owns a tile of keys and
// loops over query tiles (starting at the diagonal).  Each recomputes the
// scores it needs, so nothing S x S reaches device memory.  The TPU's
// sequential grid axis becomes that loop inside one thread block.
//
// What bounds it on the H100: at the training slice's shapes (B=8, S=4096,
// 12 heads of 64, bf16, causal) the work is operations, not bytes: per kept
// query-key pair and head, dq does three products of D multiply-adds
// (q.k, dO.v, ds.k: 6*D FLOPs) and dkv four (q.k, dO.v, p^T.dO, ds^T.q:
// 8*D FLOPs), about 3e11 and 4e11 FLOPs a layer against some 50 MB moved.
// This first version runs the products as FMAs on the CUDA cores (each
// tile staged in shared memory as f32, rows padded by one word so that the
// 16 lanes sharing a row hit 16 banks), so it is far from the tensor-core
// bound; moving them to mma.sync/wgmma is later work.  Tiles wholly masked
// by causality are never loaded, and the ragged edge is masked here, so
// any S works.
//
// Layout: q, k, v, dout are [B, S, N, D] with unit stride on D and any
// other strides (in elements); lse and delta are contiguous [B, N, S_q]
// f32; dq is a fresh contiguous [B, S_q, N, D], dk and dv fresh contiguous
// [B, S_kv, N, D].  mask, when given, is [B, S_kv] int32, nonzero = attend.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  int n_heads, s_q, s_kv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh;
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
template <typename T, int D>
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
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    const int64_t at = static_cast<int64_t>(bh) * p.s_q + row;
    lse[i] = row < p.s_q ? p.lse[at] : 0.f;
    delta[i] = row < p.s_q ? p.delta[at] : 0.f;
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
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + COL_LANES * j;
        const bool keep = key_ok[j] && (!p.causal || row >= col);
        // Explicit zero first: exp(s - lse) overflows on a masked row.
        const float pij = keep ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        dss[(ty * RPT + i) * BCP + tx + COL_LANES * j] =
            round_to<T>(pij * (dp[i][j] - delta[i]));
      }
    }
    __syncthreads();
    tile_acc<D>(dss, ks, ty, tx, acc);
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, int bn, cudaStream_t stream) {
  return launch(flash_bwd_dq_kernel<T, D>, dq_smem_bytes<D>(),
                dim3(bn, (p.s_q + BR - 1) / BR), p, stream);
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, int bn, cudaStream_t stream) {
  return launch(flash_bwd_dkv_kernel<T, D>, dkv_smem_bytes<D>(),
                dim3(bn, (p.s_kv + BR - 1) / BR), p, stream);
}

template <typename T>
cudaError_t dispatch(bool dq, const Params& p, int bn, int head_dim,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 16: return dq ? launch_dq<T, 16>(p, bn, stream)
                       : launch_dkv<T, 16>(p, bn, stream);
    case 32: return dq ? launch_dq<T, 32>(p, bn, stream)
                       : launch_dkv<T, 32>(p, bn, stream);
    case 64: return dq ? launch_dq<T, 64>(p, bn, stream)
                       : launch_dkv<T, 64>(p, bn, stream);
    case 128: return dq ? launch_dq<T, 128>(p, bn, stream)
                        : launch_dkv<T, 128>(p, bn, stream);
    case 256: return dq ? launch_dq<T, 256>(p, bn, stream)
                        : launch_dkv<T, 256>(p, bn, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dq, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta,
        const void* mask, void* dq_out, void* dk_out, void* dv_out,
        int batch, int n_heads, int s_q, int s_kv, int head_dim, int is_bf16,
        const int64_t* strides, float scale, int causal, void* stream) {
  if (s_q <= 0 || s_kv <= 0 || batch <= 0 || n_heads <= 0)
    return cudaErrorInvalidValue;
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta),
           static_cast<const int32_t*>(mask), dq_out, dk_out, dv_out,
           n_heads, s_q, s_kv,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], scale, causal};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bn = batch * n_heads;
  return is_bf16 ? dispatch<__nv_bfloat16>(dq, p, bn, head_dim, st)
                 : dispatch<float>(dq, p, bn, head_dim, st);
}

}  // namespace

extern "C" {

// Each returns cudaSuccess (0) or the launch's cudaError_t.  is_bf16
// selects __nv_bfloat16 for q, k, v, dout and the gradients; otherwise all
// are float.  strides holds the batch, sequence and head strides (in
// elements) of q, k, v and dout, in that order: 12 values.
int tf_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* mask, void* dq, int batch, int n_heads,
                    int s_q, int s_kv, int head_dim, int is_bf16,
                    const int64_t* strides, float scale, int causal,
                    void* stream) {
  return run(true, q, k, v, dout, lse, delta, mask, dq, nullptr, nullptr,
             batch, n_heads, s_q, s_kv, head_dim, is_bf16, strides, scale,
             causal, stream);
}

int tf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* mask, void* dk, void* dv, int batch,
                     int n_heads, int s_q, int s_kv, int head_dim,
                     int is_bf16, const int64_t* strides, float scale,
                     int causal, void* stream) {
  return run(false, q, k, v, dout, lse, delta, mask, nullptr, dk, dv, batch,
             n_heads, s_q, s_kv, head_dim, is_bf16, strides, scale, causal,
             stream);
}

const char* tf_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
