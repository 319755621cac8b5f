// An f32 matrix product at three precisions, for Hopper (sm_90a), with a
// plain C interface: the precision probe.
//
// Replaces the TPU kernel perf/exp_precision_probe.py:kernel (its
// pallas_call in run): a 256 x 256 f32 dot_general at precision None,
// DEFAULT or HIGHEST, whose error against a float64 product says what an
// f32 product inside a kernel really keeps.  On Hopper the question is
// what the f32 flash-attention route would lose on the tensor cores, so
// the modes are named as PyTorch names f32 matmul precision:
//   "highest"  f32 FMAs on the CUDA cores (the probe's HIGHEST);
//   "medium"   one TF32 pass on the tensor cores, mma.sync.m16n8k8.tf32 on
//              operands rounded to 10 mantissa bits (the probe's DEFAULT
//              and None, one reduced-precision pass);
//   "high"     3xTF32: x = big + small with big = tf32(x) and small =
//              tf32(x - big), and x.y ~ big.big + big.small + small.big,
//              three tensor-core passes that keep about f32's 24 bits.
// Each product of two tf32 values is exact in f32, so every mode differs
// from its plain version (ops/precision_probe.py) in summation order only.
//
// What bounds it: at 256 x 256 x 256 neither bytes (0.8 MB, 0.23 us at
// 3.35 TB/s) nor operations (3.4e7 FLOPs, 0.5 us at 67 TFLOP/s on the CUDA
// cores) but the launch: the probe measures error, not speed.  Each block
// owns a 64 x 64 tile of the output and steps over K by 32, both operand
// tiles staged in shared memory as f32, padded so that the fragment loads
// of the tensor-core modes (lanes g = 0..7 on rows, t = 0..3 on columns)
// hit 32 different banks; each of the four warps owns a 32 x 32 quarter.
// Any M, N, K: the edges are zero-filled.
//
// Layout: x [M, K], y [K, N], out [M, N], all contiguous f32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int NT = 128;
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDX = BK + 4;  // x tile [BM][LDX]: bank 4 g + t
constexpr int LDY = BN + 8;  // y tile [BK][LDY]: bank 8 t + g

enum Mode { HIGHEST = 0, HIGH = 1, MEDIUM = 2 };

template <int MODE>
__global__ void __launch_bounds__(NT)
    probe_kernel(const float* x, const float* y, float* out, int m, int n,
                 int k) {
  __shared__ float xs[BM * LDX];
  __shared__ float ys[BK * LDY];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // "highest": thread (ty, tx) owns rows ty + 8i, columns tx + 16j.
  const int ty = tid / 16, tx = tid % 16;
  float acc_f[8][4] = {};
  // tensor-core modes: warp (wm, wn) owns rows 32 wm .., columns 32 wn ..
  // as 2 x 4 m16n8 tiles.
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  float acc[2][4][4] = {};

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      xs[r * LDX + c] = m0 + r < m && k0 + c < k
                            ? x[static_cast<int64_t>(m0 + r) * k + k0 + c]
                            : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      ys[r * LDY + c] = k0 + r < k && n0 + c < n
                            ? y[static_cast<int64_t>(k0 + r) * n + n0 + c]
                            : 0.f;
    }
    __syncthreads();
    if (MODE == HIGHEST) {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = xs[(ty + 8 * i) * LDX + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ys[kk * LDY + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_f[i][j] = fmaf(a[i], b[j], acc_f[i][j]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        float af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* xr = xs + (wm * 32 + mi * 16 + g) * LDX + kk + t;
          af[mi][0] = xr[0];
          af[mi][1] = xr[8 * LDX];
          af[mi][2] = xr[4];
          af[mi][3] = xr[8 * LDX + 4];
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float* yc = ys + (kk + t) * LDY + wn * 32 + ni * 8 + g;
          bf[ni][0] = yc[0];
          bf[ni][1] = yc[4 * LDY];
        }
        uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ab[mi][e] = to_tf32(af[mi][e]);
            as[mi][e] = to_tf32(af[mi][e] - __uint_as_float(ab[mi][e]));
          }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bb[ni][e] = to_tf32(bf[ni][e]);
            bs[ni][e] = to_tf32(bf[ni][e] - __uint_as_float(bb[ni][e]));
          }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            if (MODE == HIGH) {
              // the small terms first, so that they are not lost under
              // the big one's rounding
              mma1688_tf32(acc[mi][ni], as[mi], bb[ni][0], bb[ni][1]);
              mma1688_tf32(acc[mi][ni], ab[mi], bs[ni][0], bs[ni][1]);
            }
            mma1688_tf32(acc[mi][ni], ab[mi], bb[ni][0], bb[ni][1]);
          }
      }
    }
    __syncthreads();
  }

  if (MODE == HIGHEST) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = m0 + ty + 8 * i, c = n0 + tx + 16 * j;
        if (r < m && c < n) out[static_cast<int64_t>(r) * n + c] = acc_f[i][j];
      }
  } else {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + wm * 32 + mi * 16 + g + (e >> 1) * 8;
          const int c = n0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
          if (r < m && c < n)
            out[static_cast<int64_t>(r) * n + c] = acc[mi][ni][e];
        }
  }
}

}  // namespace

extern "C" {

// out = x.y in `mode` (0 "highest", 1 "high", 2 "medium"); returns
// cudaSuccess (0) or the launch's cudaError_t.
int tf_precision_probe(const void* x, const void* y, void* out, int m, int n,
                       int k, int mode, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* o = static_cast<float*>(out);
  switch (mode) {
    case HIGHEST: probe_kernel<HIGHEST><<<grid, NT, 0, st>>>(xf, yf, o, m, n, k); break;
    case HIGH: probe_kernel<HIGH><<<grid, NT, 0, st>>>(xf, yf, o, m, n, k); break;
    case MEDIUM: probe_kernel<MEDIUM><<<grid, NT, 0, st>>>(xf, yf, o, m, n, k); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* tf_precision_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
