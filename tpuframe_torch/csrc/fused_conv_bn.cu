// Fused 1x1-conv + BatchNorm backward (pass 2) for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the TPU kernel tpuframe/ops/fused_conv_bn.py:_bwd_kernel (its
// pallas_call in _fused_bwd_matmuls).  Same function: given the 1x1 conv's
// input a [M, K], its weight W [K, C] in the compute dtype, the conv output
// x [M, C], the BN output cotangent dy [M, C] and the folded per-channel
// coefficients coef [3, C] f32 (rows s, u, c), it forms
//   g = s*dy - u*x + c          in f32, rounded once to the compute dtype,
//   da = g . W^T   [M, K]       in a's dtype,
//   dW = a^T . g   [K, C]       in f32,
// with f32 accumulators.  g never reaches device memory: each block
// recomputes the g tile it needs from x, dy and coef in shared memory.  The
// three f32 operations of g are rounded one by one (no contraction into an
// FMA), so g is bit-equal to the plain PyTorch version's.
//
// The TPU kernel carries dW in VMEM across a sequential grid.  Blocks here
// run in parallel and in no order, so dW is split over rows instead: the
// dW kernel gives each block one (K, C) tile and one contiguous slice of
// rows, and it writes its f32 partial sum to a workspace [splits, K, C];
// a second kernel adds the partials in split order.  No atomics, so the
// result is deterministic.  With one split the dW kernel writes dW itself.
// da needs no reduction across blocks: the da kernel owns a (rows, K) tile
// and loops over C.
//
// What bounds it on the H100: at ResNet-50's shapes (batch 256, M = 12,544
// to 802,816 rows, K and C 64 to 2048) the two products are 4*M*K*C FLOPs
// against 2*M*(K + 2C) bytes of bf16 activations moved; the per-shape bound
// is bytes where K and C are small and operations where they are large
// (about 5 ms a training step summed over the 36 calls).  This first
// version runs the products as FMAs on the CUDA cores: tiles of 16
// reduction steps staged in shared memory as f32, each thread holding an
// 8x4 (da) or 4x8 (dW) register tile, so every shared-memory load feeds
// eight FMAs.  It reads x and dy twice (once per product kernel) and so
// moves more than the bound counts; tensor-core tiles (mma.sync, then
// wgmma) are later work.  The ragged edges in M, K and C are masked here,
// so every shape works.
//
// Layout: every operand is a fresh contiguous row-major array: a and da
// [M, K], w [K, C], x and dy [M, C], coef [3, C], dw [K, C], and the
// workspace [splits, K, C] when splits > 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads: a 16 x 16 grid
constexpr int BKK = 16;   // reduction steps staged per tile
constexpr int PAD = 4;    // floats of padding per staged row

// da kernel: a block owns DA_BM rows x DA_BN columns of K.
constexpr int DA_BM = 128;
constexpr int DA_BN = 64;
constexpr int DA_TM = DA_BM / 16;   // 8 rows per thread
constexpr int DA_TN = DA_BN / 16;   // 4 columns per thread

// dW kernel: a block owns DW_BM entries of K x DW_BN entries of C.
constexpr int DW_BM = 64;
constexpr int DW_BN = 128;
constexpr int DW_TM = DW_BM / 16;   // 4 K entries per thread
constexpr int DW_TN = DW_BN / 16;   // 8 C entries per thread, as 2 x 4

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
  return __float2bfloat16_rn(x);
}

// g = s*dy - u*x + c in f32, each operation rounded on its own, then
// rounded to the compute dtype T once (the TPU kernel's .astype before its
// two dots).
template <typename T>
__device__ __forceinline__ float g_value(T x, T dy, float s, float u,
                                         float c) {
  const float gf = __fadd_rn(
      __fsub_rn(__fmul_rn(s, to_f32(dy)), __fmul_rn(u, to_f32(x))), c);
  return to_f32(from_f32<T>(gf));
}

// da[m, k] = sum_c g[m, c] * W[k, c].  Grid: (row tiles, K tiles).
template <typename T>
__global__ void __launch_bounds__(NT)
    da_kernel(const T* __restrict__ w, const T* __restrict__ x,
              const T* __restrict__ dy, const float* __restrict__ coef,
              T* __restrict__ da, int64_t m, int k, int c) {
  __shared__ __align__(16) float gs[BKK][DA_BM + PAD];   // g^T tile
  __shared__ __align__(16) float ws[BKK][DA_BN + PAD];   // W^T tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * DA_BM;
  const int k0 = blockIdx.y * DA_BN;
  const float* s = coef;
  const float* u = coef + c;
  const float* cc = coef + 2 * c;

  float acc[DA_TM][DA_TN];
#pragma unroll
  for (int i = 0; i < DA_TM; ++i)
#pragma unroll
    for (int j = 0; j < DA_TN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < c; c0 += BKK) {
    // g tile: DA_BM rows x BKK channels; 16 neighbouring threads read one
    // row's 16 channels.
#pragma unroll
    for (int i = 0; i < DA_BM * BKK / NT; ++i) {
      const int e = tid + i * NT;
      const int row = e / BKK, col = e % BKK;
      const int64_t gm = m0 + row;
      const int gc = c0 + col;
      float g = 0.f;
      if (gm < m && gc < c) {
        const int64_t off = gm * c + gc;
        g = g_value(x[off], dy[off], __ldg(s + gc), __ldg(u + gc),
                    __ldg(cc + gc));
      }
      gs[col][row] = g;
    }
#pragma unroll
    for (int i = 0; i < DA_BN * BKK / NT; ++i) {
      const int e = tid + i * NT;
      const int row = e / BKK, col = e % BKK;
      const int gk = k0 + row;
      const int gc = c0 + col;
      ws[col][row] = (gk < k && gc < c)
                         ? to_f32(w[static_cast<int64_t>(gk) * c + gc])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKK; ++kk) {
      float av[DA_TM], bv[DA_TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&gs[kk][ty * DA_TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&gs[kk][ty * DA_TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * DA_TN]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
#pragma unroll
      for (int i = 0; i < DA_TM; ++i)
#pragma unroll
        for (int j = 0; j < DA_TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < DA_TM; ++i) {
    const int64_t gm = m0 + ty * DA_TM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < DA_TN; ++j) {
      const int gk = k0 + tx * DA_TN + j;
      if (gk < k) da[gm * k + gk] = from_f32<T>(acc[i][j]);
    }
  }
}

// Partial dW over one slice of rows: out[k, c] = sum_{m in slice}
// a[m, k] * g[m, c].  Grid: (K tiles, C tiles, splits); `out` is dW itself
// when there is one split, else the split's [K, C] slab of the workspace.
template <typename T>
__global__ void __launch_bounds__(NT)
    dw_kernel(const T* __restrict__ a, const T* __restrict__ x,
              const T* __restrict__ dy, const float* __restrict__ coef,
              float* __restrict__ out, int64_t m, int k, int c,
              int64_t rows_per_split) {
  __shared__ __align__(16) float as[BKK][DW_BM + PAD];   // a tile
  __shared__ __align__(16) float gs[BKK][DW_BN + PAD];   // g tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * DW_BM;
  const int c0 = blockIdx.y * DW_BN;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * rows_per_split;
  const int64_t r_stop = r_begin + rows_per_split;
  const int64_t r_end = r_stop < m ? r_stop : m;
  out += static_cast<int64_t>(blockIdx.z) * k * c;

  // A thread stages the same channel of the g tile on every row it loads
  // (NT is a multiple of DW_BN), so it reads that channel's coefficients
  // once.
  static_assert(NT % DW_BN == 0, "g-tile channel must be fixed per thread");
  const int my_c = c0 + tid % DW_BN;
  const bool c_in = my_c < c;
  const float cs = c_in ? __ldg(coef + my_c) : 0.f;
  const float cu = c_in ? __ldg(coef + c + my_c) : 0.f;
  const float ccc = c_in ? __ldg(coef + 2 * c + my_c) : 0.f;

  float acc[DW_TM][DW_TN];
#pragma unroll
  for (int i = 0; i < DW_TM; ++i)
#pragma unroll
    for (int j = 0; j < DW_TN; ++j) acc[i][j] = 0.f;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += BKK) {
    // a tile: BKK rows x DW_BM entries of K, neighbouring threads on
    // neighbouring K.
#pragma unroll
    for (int i = 0; i < DW_BM * BKK / NT; ++i) {
      const int e = tid + i * NT;
      const int row = e / DW_BM, col = e % DW_BM;
      const int64_t gm = r0 + row;
      const int gk = k0 + col;
      as[row][col] = (gm < r_end && gk < k) ? to_f32(a[gm * k + gk]) : 0.f;
    }
    // g tile: BKK rows x DW_BN channels.
#pragma unroll
    for (int i = 0; i < DW_BN * BKK / NT; ++i) {
      const int e = tid + i * NT;
      const int row = e / DW_BN, col = e % DW_BN;
      const int64_t gm = r0 + row;
      float g = 0.f;
      if (gm < r_end && c_in) {
        const int64_t off = gm * c + my_c;
        g = g_value(x[off], dy[off], cs, cu, ccc);
      }
      gs[row][col] = g;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKK; ++kk) {
      float av[DW_TM], bv[DW_TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * DW_TM]);
      // Columns tx*4..+3 and 64+tx*4..+3: each 16-byte load of a warp
      // covers 256 contiguous bytes, free of bank conflicts.
      const float4 b0 = *reinterpret_cast<const float4*>(&gs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&gs[kk][DW_BN / 2 + tx * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < DW_TM; ++i)
#pragma unroll
        for (int j = 0; j < DW_TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < DW_TM; ++i) {
    const int gk = k0 + ty * DW_TM + i;
    if (gk >= k) continue;
#pragma unroll
    for (int j = 0; j < DW_TN; ++j) {
      const int gc = c0 + (j < 4 ? tx * 4 + j : DW_BN / 2 + tx * 4 + j - 4);
      if (gc < c) out[static_cast<int64_t>(gk) * c + gc] = acc[i][j];
    }
  }
}

// dW[i] = sum over splits, in split order, of part[split][i].
__global__ void __launch_bounds__(NT)
    dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                     int64_t n, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += part[sp * n + i];
  dw[i] = sum;
}

template <typename T>
cudaError_t run(const void* a, const void* w, const void* x, const void* dy,
                const float* coef, void* da, float* dw, float* workspace,
                int64_t m, int k, int c, int splits, cudaStream_t stream) {
  const int64_t rows_per_split =
      ((m + splits - 1) / splits + BKK - 1) / BKK * BKK;
  if (splits < 1 || (splits > 1 && workspace == nullptr) ||
      (splits - 1) * rows_per_split >= m)
    return cudaErrorInvalidValue;
  const int64_t m_tiles = (m + DA_BM - 1) / DA_BM;
  if (m_tiles > 0x7fffffff) return cudaErrorInvalidValue;

  da_kernel<T><<<dim3(static_cast<unsigned>(m_tiles),
                      (k + DA_BN - 1) / DA_BN),
                 NT, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(x),
      static_cast<const T*>(dy), coef, static_cast<T*>(da), m, k, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  float* out = splits == 1 ? dw : workspace;
  dw_kernel<T><<<dim3((k + DW_BM - 1) / DW_BM, (c + DW_BN - 1) / DW_BN,
                      splits),
                 NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const T*>(dy), coef, out, m, k, c, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;

  const int64_t n = static_cast<int64_t>(k) * c;
  dw_reduce_kernel<<<static_cast<unsigned>((n + NT - 1) / NT), NT, 0,
                     stream>>>(workspace, dw, n, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaSuccess (0) or the first failing launch's cudaError_t.
// is_bf16 selects __nv_bfloat16 for a, w, x, dy and da; otherwise all are
// float.  coef, dw and the workspace are float.  splits >= 1 slices of
// ceil(ceil(m / splits) / 16) * 16 rows each share the dW reduction;
// workspace holds splits * k * c floats when splits > 1 (else may be
// null), and the last slice must not be empty.
int tf_fused_conv_bn_bwd(const void* a, const void* w, const void* x,
                         const void* dy, const void* coef, void* da,
                         void* dw, void* workspace, int64_t m, int k, int c,
                         int splits, int is_bf16, void* stream) {
  if (m <= 0 || k <= 0 || c <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(coef);
  float* dwf = static_cast<float*>(dw);
  float* ws = static_cast<float*>(workspace);
  return is_bf16 ? run<__nv_bfloat16>(a, w, x, dy, cf, da, dwf, ws, m, k, c,
                                      splits, st)
                 : run<float>(a, w, x, dy, cf, da, dwf, ws, m, k, c, splits,
                              st);
}

const char* tf_fused_conv_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
