// Fused 1x1-conv + BatchNorm backward (pass 2) for Hopper (sm_90a), with a
// plain C interface, in two routes.
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
// recomputes the g it needs from x, dy and coef.  The three f32
// operations of g are rounded one by one (no contraction into an FMA), so
// g is bit-equal to the plain PyTorch version's.
//
// The TPU kernel carries dW in VMEM across a sequential grid.  Blocks here
// run in parallel and in no order, so dW is split over rows instead: each
// dW block owns one (K, C) tile and one contiguous slice of rows and
// writes its f32 partial sum to a workspace [splits, K, C]; a second
// kernel adds the partials in split order.  No atomics, so the result is
// deterministic.  With one split the dW kernel writes dW itself.  da needs
// no reduction across blocks: a da block owns a (rows, K) tile and loops
// over C.
//
// What bounds it on the H100: at ResNet-50's shapes (batch 256, M = 12,544
// to 802,816 rows, K and C 64 to 2048) the two products are 4*M*K*C FLOPs
// against 2*M*(2K + 2C) bytes of bf16 activations moved; the bound is
// bytes where K and C are small (10 of the 15 shapes) and operations where
// they are large, about 5.2 ms summed over a training step's 36 calls.
// Both kernels read x and dy, so the pair moves at least 2*M*C*2 bytes
// more than that bound counts.
//
// Tensor-core route (bf16, K and C multiples of 64, 16-byte aligned data):
// both products are wgmma (bf16 x bf16 -> f32) issued by warpgroups of
// four warps, with g built in registers directly as the register A
// operand, so it touches neither device nor shared memory.  Tiles are
// loaded by 16-byte cp.async in two stages, in wgmma's 128-byte swizzle.
//   da: a block (one warpgroup) owns 64 rows and NK = 64, 128 or 256
//   columns of K (up to 128 f32 accumulators a thread), so x and dy are
//   read K/256 times, not K/64 as before.  Per step of 64 channels it
//   stages x, dy (64 x 64), W (NK x 64) and coef; each thread builds g for
//   its rows g and g+8 and channel pairs 2t, 2t+8 of each 16-channel step
//   straight into the m16n8k16 A layout, and W's [K, C] rows are B read
//   K-major.
//   dW: the product is taken transposed, dW^T = g^T . a, so that g^T is
//   again a register A operand: a block (one or two warpgroups) owns 64 or
//   128 channels and NK = 64 or 128 columns of K, and each thread's two
//   channels (g and g+8 of its warp's 16) keep their coefficients in
//   registers.  Per step of 64 rows it stages a (64 x NK), x and dy
//   (64 x channels); ldmatrix.trans reads x and dy as the A fragments of
//   their transposes, and a's tile is B read MN-major.  The tensor cores
//   truncate rather than round as they accumulate (the precision probe),
//   so a split is at most 2048 rows (128 wgmma steps) and the partials are
//   added in f32 by the reduce kernel.
//
// CUDA-core route (f32, or K or C not a multiple of 64): the products are
// FMAs, tiles of 16 reduction steps staged in shared memory as f32, each
// thread holding an 8x4 (da) or 4x8 (dW) register tile.  The ragged edges
// in M, K and C are masked, so every shape works.
//
// Layout: every operand is a fresh contiguous row-major array: a and da
// [M, K], w [K, C], x and dy [M, C], coef [3, C], dw [K, C], and the
// workspace [splits, K, C] when splits > 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tiles.cuh"

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

// g = s*dy - u*x + c in f32, each operation rounded on its own.
__device__ __forceinline__ float g_f32(float x, float dy, float s, float u,
                                       float c) {
  return __fadd_rn(__fsub_rn(__fmul_rn(s, dy), __fmul_rn(u, x)), c);
}

// g rounded to the compute dtype T once (the TPU kernel's .astype before
// its two dots).
template <typename T>
__device__ __forceinline__ float g_value(T x, T dy, float s, float u,
                                         float c) {
  return to_f32(from_f32<T>(g_f32(to_f32(x), to_f32(dy), s, u, c)));
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

// ---------------------------------------------------------------------------
// Tensor-core route: bf16, K and C multiples of 64.

constexpr int TC_T = 128;     // threads of a warpgroup
constexpr int TC_ROWS = 64;   // rows of a staged step (M in da, K in dW)
constexpr int TC_C = 64;      // channels of a da step

// g for two neighbouring entries (x, dy as packed bf16 pairs) and their
// coefficients, rounded to bf16 and packed: an A operand register.
__device__ __forceinline__ uint32_t g_pair(uint32_t x2, uint32_t dy2,
                                           float s0, float u0, float c0,
                                           float s1, float u1, float c1) {
  const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(&x2);
  const __nv_bfloat162 dv = *reinterpret_cast<const __nv_bfloat162*>(&dy2);
  return pack_bf16(
      g_f32(__bfloat162float(xv.x), __bfloat162float(dv.x), s0, u0, c0),
      g_f32(__bfloat162float(xv.y), __bfloat162float(dv.y), s1, u1, c1));
}

template <int NK>
constexpr size_t da_tc_smem_bytes() {
  return 2 * (sizeof(bf16) * (2 * TC_ROWS + NK) * TC_C +
              sizeof(float) * 3 * TC_C) +
         TC_ALIGN;
}

// da[m, k] for a tile of 64 rows and NK columns of K.  A 1-D grid of
// (row tile, K tile), K tile fastest, so that the blocks in flight share
// their rows of x and dy in L2.
template <int NK>
__global__ void __launch_bounds__(TC_T, NK == 256 ? 1 : 2)
    da_tc_kernel(const bf16* __restrict__ w, const bf16* __restrict__ x,
                 const bf16* __restrict__ dy, const float* __restrict__ coef,
                 bf16* __restrict__ da, int m, int k, int c) {
  constexpr int BN = NK < 128 ? NK : 128;   // columns of one wgmma
  constexpr int NB = NK / BN;               // wgmmas a k-step
  constexpr int STAGE = (2 * TC_ROWS + NK) * TC_C;  // bf16 a stage
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* base = tc_smem_base(tc_smem);  // [2][x 64x64 | dy 64x64 | W NKx64]
  float* coef_s = reinterpret_cast<float*>(base + 2 * STAGE);  // [2][3][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k_tiles = k / NK;
  const int k0 = (blockIdx.x % k_tiles) * NK;
  const int m0 = (blockIdx.x / k_tiles) * TC_ROWS;
  const int n_steps = c / TC_C;

  auto load = [&](int step) {
    const int c0 = step * TC_C;
    bf16* st = base + (step & 1) * STAGE;
    tc_load_tile<TC_C, TC_ROWS>(st, x + c0, c, m0, m, tid);
    tc_load_tile<TC_C, TC_ROWS>(st + TC_ROWS * TC_C, dy + c0, c, m0, m, tid);
    tc_load_tile<TC_C, NK>(st + 2 * TC_ROWS * TC_C, w + c0, c, k0, k, tid);
    if (tid < 3 * TC_C / 4) {   // coef[:, c0 .. c0+63], 16 bytes a thread
      const int row = tid / (TC_C / 4), q = tid % (TC_C / 4);
      cp_async16(coef_s + (step & 1) * 3 * TC_C + row * TC_C + q * 4,
                 coef + static_cast<int64_t>(row) * c + c0 + q * 4, true);
    }
  };

  float acc[NB][BN / 8][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][nt][e] = 0.f;

  // This thread's rows of the tile: r0 and r0 + 8.
  const int r0 = warp * 16 + g;
  load(0);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      load(step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();  // W's tile is read by wgmma
    __syncthreads();
    const bf16* st = base + (step & 1) * STAGE;
    const char* xs = reinterpret_cast<const char*>(st);
    const char* ds = reinterpret_cast<const char*>(st + TC_ROWS * TC_C);
    const bf16* ws = st + 2 * TC_ROWS * TC_C;
    const float* cf = coef_s + (step & 1) * 3 * TC_C;

    uint32_t a[TC_C / 16][4];
#pragma unroll
    for (int kk = 0; kk < TC_C / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a0 = (r0, 2t..), a1 = (r0+8, 2t..), a2 = (r0, 2t+8..), a3 = ...
        const int row = r0 + (i & 1) * 8, col = kk * 16 + (i >> 1) * 8 +
                                                tig * 2;
        const int off = tc_chunk<TC_ROWS>(row, col) + (col & 7) * 2;
        const float2 sv = *reinterpret_cast<const float2*>(cf + col);
        const float2 uv = *reinterpret_cast<const float2*>(cf + TC_C + col);
        const float2 cv =
            *reinterpret_cast<const float2*>(cf + 2 * TC_C + col);
        a[kk][i] = g_pair(*reinterpret_cast<const uint32_t*>(xs + off),
                          *reinterpret_cast<const uint32_t*>(ds + off), sv.x,
                          uv.x, cv.x, sv.y, uv.y, cv.y);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_C / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_rs<K_MAJOR>(acc[nb], a[kk],
                          tc_desc_k<NK>(ws + nb * BN * TC_C, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_operand(acc[nb]);
    fence_operand(a);
    __syncthreads();  // this stage is reloaded two steps on
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + r0 + half * 8;
    if (row >= m) continue;
    bf16* dst = da + static_cast<int64_t>(row) * k + k0;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(dst + nb * BN + nt * 8 +
                                           tig * 2) =
            __floats2bfloat162_rn(acc[nb][nt][2 * half],
                                  acc[nb][nt][2 * half + 1]);
  }
}

template <int NK, int WG>
constexpr size_t dw_tc_smem_bytes() {
  return 2 * sizeof(bf16) * TC_ROWS * (NK + 2 * 64 * WG) + TC_ALIGN;
}

// Partial dW over one slice of rows for a tile of 64*WG channels (one
// warpgroup each) and NK columns of K, taken as dW^T = g^T . a.  A 1-D
// grid of (C tile, K tile, split), C tile fastest; `out` is dW itself
// when there is one split, else the split's [K, C] slab of the workspace.
template <int NK, int WG>
__global__ void __launch_bounds__(TC_T * WG, 2)
    dw_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ x,
                 const bf16* __restrict__ dy, const float* __restrict__ coef,
                 float* __restrict__ out, int m, int k, int c,
                 int rows_per_split) {
  constexpr int CT = 64 * WG;                        // channels a block
  constexpr int STAGE = TC_ROWS * (NK + 2 * CT);     // bf16 a stage
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* base = tc_smem_base(tc_smem);  // [2][a 64xNK | x 64xCT | dy 64xCT]

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int c_tiles = c / CT, k_tiles = k / NK;
  const int c0 = (blockIdx.x % c_tiles) * CT;
  const int k0 = (blockIdx.x / c_tiles % k_tiles) * NK;
  const int split = blockIdx.x / c_tiles / k_tiles;
  const int r_begin = split * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);
  out += static_cast<int64_t>(split) * k * c;
  const int n_steps = (r_end - r_begin + TC_ROWS - 1) / TC_ROWS;

  // This thread's two channels, tile-relative, and their coefficients.
  const int ch = wg * 64 + warp * 16 + g;
  float cs[2], cu[2], cc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    cs[i] = __ldg(coef + c0 + ch + 8 * i);
    cu[i] = __ldg(coef + c + c0 + ch + 8 * i);
    cc[i] = __ldg(coef + 2 * c + c0 + ch + 8 * i);
  }

  auto load = [&](int step) {
    const int rr = r_begin + step * TC_ROWS;
    bf16* st = base + (step & 1) * STAGE;
    tc_load_tile<NK, TC_ROWS, TC_T * WG>(st, a + k0, k, rr, r_end, tid);
    tc_load_tile<CT, TC_ROWS, TC_T * WG>(st + TC_ROWS * NK, x + c0, c, rr,
                                         r_end, tid);
    tc_load_tile<CT, TC_ROWS, TC_T * WG>(st + TC_ROWS * (NK + CT), dy + c0,
                                         c, rr, r_end, tid);
  };

  float acc[NK / 8][4];
#pragma unroll
  for (int nt = 0; nt < NK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  // ldmatrix row of this lane: matrix lane/8 holds rows +8 (matrices 2, 3)
  // and channels +8 (matrices 1, 3) of the warp's 16 x 16 step.
  const int lm_row = (lane & 7) + ((lane >> 4) << 3);
  const int lm_ch = wg * 64 + warp * 16 + ((lane >> 3) & 1) * 8;
  load(0);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      load(step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();  // a's tile is read by wgmma
    __syncthreads();
    const bf16* st = base + (step & 1) * STAGE;
    const char* xs = reinterpret_cast<const char*>(st + TC_ROWS * NK);
    const char* ds = reinterpret_cast<const char*>(st + TC_ROWS * (NK + CT));

    uint32_t ga[TC_ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < TC_ROWS / 16; ++kk) {
      const int off = tc_chunk<TC_ROWS>(kk * 16 + lm_row, lm_ch);
      uint32_t xr[4], dr[4];
      ldmatrix_x4_trans(xr, xs + off);
      ldmatrix_x4_trans(dr, ds + off);
      // registers 0, 2: channel g; 1, 3: channel g+8 (rows 2t, 2t+1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ga[kk][i] = g_pair(xr[i], dr[i], cs[i & 1], cu[i & 1], cc[i & 1],
                           cs[i & 1], cu[i & 1], cc[i & 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_ROWS / 16; ++kk)
      wgmma_rs<MN_MAJOR>(acc, ga[kk], tc_desc_mn<TC_ROWS>(st, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    fence_operand(ga);
    __syncthreads();  // this stage is reloaded two steps on
  }

  // acc[nt][e]: channel ch (e < 2) or ch + 8, K column nt*8 + 2t + (e & 1).
#pragma unroll
  for (int nt = 0; nt < NK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + nt * 8 + tig * 2 + (e & 1);
      out[static_cast<int64_t>(kk) * c + c0 + ch + (e >> 1) * 8] =
          acc[nt][e];
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The tensor-core kernels' tiles: NK of da, (NK, channel warpgroups) of
// dW, from K and C (multiples of 64).
int tc_da_nk(int k) { return k % 256 == 0 ? 256 : k % 128 == 0 ? 128 : 64; }
int tc_dw_nk(int k) { return k % 128 == 0 ? 128 : 64; }
int tc_dw_wg(int c) { return c % 128 == 0 ? 2 : 1; }

using DaFn = void (*)(const bf16*, const bf16*, const bf16*, const float*,
                      bf16*, int, int, int);
using DwFn = void (*)(const bf16*, const bf16*, const bf16*, const float*,
                      float*, int, int, int, int);

// f(kernel, smem bytes, threads) for the da kernel of K.
template <typename F>
cudaError_t with_da_tc(int k, F&& f) {
  switch (tc_da_nk(k)) {
    case 256: return f(DaFn(da_tc_kernel<256>), da_tc_smem_bytes<256>(), TC_T);
    case 128: return f(DaFn(da_tc_kernel<128>), da_tc_smem_bytes<128>(), TC_T);
    default: return f(DaFn(da_tc_kernel<64>), da_tc_smem_bytes<64>(), TC_T);
  }
}

// f(kernel, smem bytes, threads) for the dW kernel of (K, C).
template <typename F>
cudaError_t with_dw_tc(int k, int c, F&& f) {
  const int nk = tc_dw_nk(k), wg = tc_dw_wg(c);
#define TF_DW(NK, WG)                                                      \
  if (nk == NK && wg == WG)                                                \
    return f(DwFn(dw_tc_kernel<NK, WG>), dw_tc_smem_bytes<NK, WG>(),       \
             TC_T * WG);
  TF_DW(128, 2)
  TF_DW(128, 1)
  TF_DW(64, 2)
  TF_DW(64, 1)
#undef TF_DW
  return cudaErrorInvalidValue;
}

cudaError_t run_tc(const bf16* a, const bf16* w, const bf16* x,
                   const bf16* dy, const float* coef, bf16* da, float* dw,
                   float* workspace, int m, int k, int c, int splits,
                   int rows_per_split, cudaStream_t stream) {
  if (k % 64 != 0 || c % 64 != 0 || rows_per_split % TC_ROWS != 0)
    return cudaErrorInvalidValue;
  const void* ptrs[8] = {a, w, x, dy, coef, da, dw, workspace};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  const int64_t da_blocks =
      static_cast<int64_t>((m + TC_ROWS - 1) / TC_ROWS) * (k / tc_da_nk(k));
  const int64_t dw_blocks = static_cast<int64_t>(splits) *
                            (k / tc_dw_nk(k)) * (c / (64 * tc_dw_wg(c)));
  if (da_blocks > 0x7fffffff || dw_blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaError_t err =
      with_da_tc(k, [&](DaFn kernel, size_t smem, int threads) {
        const cudaError_t e = allow_smem(kernel, smem);
        if (e != cudaSuccess) return e;
        kernel<<<static_cast<unsigned>(da_blocks), threads, smem, stream>>>(
            w, x, dy, coef, da, m, k, c);
        return cudaGetLastError();
      });
  if (err != cudaSuccess) return err;
  float* out = splits == 1 ? dw : workspace;
  return with_dw_tc(k, c, [&](DwFn kernel, size_t smem, int threads) {
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<unsigned>(dw_blocks), threads, smem, stream>>>(
        a, x, dy, coef, out, m, k, c, rows_per_split);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t run_cuda_core(const void* a, const void* w, const void* x,
                          const void* dy, const float* coef, void* da,
                          float* dw, float* workspace, int64_t m, int k,
                          int c, int splits, int64_t rows_per_split,
                          cudaStream_t stream) {
  if (rows_per_split % BKK != 0) return cudaErrorInvalidValue;
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
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaSuccess (0) or the first failing launch's cudaError_t.
// is_bf16 selects __nv_bfloat16 for a, w, x, dy and da; otherwise all are
// float.  coef, dw and the workspace are float.  tensor_core selects the
// tensor-core kernels (bf16, k and c multiples of 64, 16-byte aligned
// data).  splits slices of rows_per_split rows (a multiple of 16 on the
// CUDA cores, of 64 on the tensor cores; the last slice not empty) share
// the dW reduction; workspace holds splits * k * c floats when splits > 1
// (else may be null).
int tf_fused_conv_bn_bwd(const void* a, const void* w, const void* x,
                         const void* dy, const void* coef, void* da,
                         void* dw, void* workspace, int64_t m, int k, int c,
                         int splits, int64_t rows_per_split, int is_bf16,
                         int tensor_core, void* stream) {
  if (m <= 0 || k <= 0 || c <= 0 || splits < 1 || rows_per_split <= 0 ||
      (splits > 1 && workspace == nullptr) ||
      (splits - 1) * rows_per_split >= m || splits * rows_per_split < m)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(coef);
  float* dwf = static_cast<float*>(dw);
  float* ws = static_cast<float*>(workspace);
  cudaError_t err;
  if (tensor_core) {
    if (!is_bf16 || m > 0x7fffffff) return cudaErrorInvalidValue;
    err = run_tc(static_cast<const bf16*>(a), static_cast<const bf16*>(w),
                 static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                 cf, static_cast<bf16*>(da), dwf, ws, static_cast<int>(m),
                 k, c, splits, static_cast<int>(rows_per_split), st);
  } else {
    err = is_bf16 ? run_cuda_core<__nv_bfloat16>(a, w, x, dy, cf, da, dwf,
                                                 ws, m, k, c, splits,
                                                 rows_per_split, st)
                  : run_cuda_core<float>(a, w, x, dy, cf, da, dwf, ws, m, k,
                                         c, splits, rows_per_split, st);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t n = static_cast<int64_t>(k) * c;
  dw_reduce_kernel<<<static_cast<unsigned>((n + NT - 1) / NT), NT, 0, st>>>(
      ws, dwf, n, splits);
  return cudaGetLastError();
}

// The dynamic shared memory and blocks an SM of the tensor-core da
// (which = 0) or dW (which = 1) kernel for (k, c).
int tf_fused_conv_bn_kernel_info(int which, int k, int c, int* smem_bytes,
                                 int* blocks_per_sm) {
  auto info = [&](auto kernel, size_t smem, int threads) {
    *smem_bytes = static_cast<int>(smem);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                         kernel, threads,
                                                         smem);
  };
  if (k % 64 != 0 || c % 64 != 0) return cudaErrorInvalidValue;
  return which == 0 ? with_da_tc(k, info) : with_dw_tc(k, c, info);
}

const char* tf_fused_conv_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
