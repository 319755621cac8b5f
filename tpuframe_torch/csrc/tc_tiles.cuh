// Shared pieces of the port's wgmma kernels: bf16 tiles in wgmma's
// 128-byte swizzle, loaded into shared memory by 16-byte cp.async, their
// descriptors, and the operand packing.
//
// A tile of R rows and COLS bf16 columns is COLS/64 column blocks of
// [R][64]; the 16-byte chunk c of row r sits at chunk c ^ (r % 8), so the
// eight rows of a 1024-byte atom spread one chunk column over all banks.
// Read K-major (the reduction index runs along the row) or MN-major (the
// output index runs along it); see mma.cuh for the descriptor layouts.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

using bf16 = __nv_bfloat16;

// Dynamic shared memory is realigned to 1024 bytes inside each kernel.
constexpr int TC_ALIGN = 1024;

// (lo, hi) rounded to bf16 (to nearest even) in one register, lo in the
// low half: the layout of an mma operand pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows r0 .. r0+R-1 of a bf16 array with row stride row_stride (elements)
// into the swizzled tile at dst (1024-byte aligned) by THREADS threads:
// COLS columns from src on.  Rows at or past n are zero-filled.
template <int COLS, int R, int THREADS = 128>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src,
                                             int64_t row_stride, int r0,
                                             int n, int tid) {
  constexpr int CH = COLS / 8;  // 16-byte chunks a row
  static_assert((R * CH) % THREADS == 0 && R % 8 == 0 && COLS % 64 == 0,
                "tile shape");
  char* d = reinterpret_cast<char*>(dst);
#pragma unroll
  for (int it = 0; it < R * CH / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < n;
    cp_async16(d + (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               ok ? src + static_cast<int64_t>(r0 + r) * row_stride + c * 8
                  : src,
               ok);
  }
}

// The K-major descriptor of k-step kk (16 columns) of an R-row tile.
template <int R>
__device__ __forceinline__ uint64_t tc_desc_k(const bf16* tile, int kk) {
  return gmma_desc(reinterpret_cast<const char*>(tile) + (kk >> 2) * (R * 128) +
                       (kk & 3) * 32,
                   16, 1024);
}

// The MN-major descriptor of k-step j (rows 16j .. 16j+15) of an R-row
// tile read as B = tile[k][n].
template <int R>
__device__ __forceinline__ uint64_t tc_desc_mn(const bf16* tile, int j) {
  return gmma_desc(reinterpret_cast<const char*>(tile) + j * 2048, R * 128,
                   1024);
}

// Byte offset of the 16-byte chunk holding column c (a multiple of 8) of
// row r in a swizzled R-row tile.
template <int R>
__device__ __forceinline__ int tc_chunk(int r, int c) {
  return (c >> 6) * (R * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4);
}

// The kernel's dynamic shared memory, from its first 1024-byte boundary.
__device__ __forceinline__ bf16* tc_smem_base(unsigned char* raw) {
  return reinterpret_cast<bf16*>(
      raw + ((TC_ALIGN - (smem_addr(raw) & (TC_ALIGN - 1))) & (TC_ALIGN - 1)));
}
