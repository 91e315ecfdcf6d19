// Shared helpers of the fargocpt_torch CUDA kernels.
//
// Every kernel works on row-major (rows, NAZ) fields of one floating type
// T (float or double). Radial geometry arrives as one row-major column
// table `cols` of shape (NR+1, N_COLS), built on the host in float64 and
// cast to T (fargocpt_torch/ops/kernels.py make_columns); the column order
// below must match KERNEL_COLUMNS there.
//
// C interface: every op exports
//   int fc_<op>_<f32|f64>(void* const* ptrs, const double* fp,
//                         const int* ip, void* stream)
// with device pointers in `ptrs`, static float parameters in `fp`, static
// integer parameters (shapes, flags) in `ip`, and the CUDA stream. It
// enqueues its launches on `stream`, never synchronises, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace fc {

enum Col {
  C_RB = 0,
  C_INV_RB,
  C_RA,
  C_INV_RA,
  C_INVDRM,           // 1 / (Rmed[i] - Rmed[i-1]); row 0 is 0
  C_INV_DIFF_RSUP,
  C_INV_DIFF_RSUP_RB,
  C_TWO_DIFF_RA_SQ,
  C_INV_SURF,
  C_CM,               // Rmed[f] - Rmed[f-1]; row 0 is 0
  C_CP,               // Rmed[f+1] - Rmed[f]; row NR is 0
  C_COEF,             // Rsup - Rinf
  C_SRC_INVDXTHETA,   // 2 / (dphi (Rsup + Rinf))
  C_HFAC,             // H / cs
  C_CS_ISO,
  C_OMEGA_K,
  C_DRIFT,            // imposed disk drift per ring
  C_INV_CELL,         // 1 / min(Rsup - Rinf, Rmed dphi)
  C_INV_DXRAD,
  C_INV_DXAZ,
  C_SUM_RS_RI,        // Rsup + Rinf
  C_L_SQ,             // (C l)^2 of the tensor artificial viscosity
  N_COLS_USED
};
constexpr int N_COLS = 24;
static_assert(N_COLS_USED <= N_COLS, "column table too narrow");

constexpr int BLOCK = 256;

template <typename T>
__device__ __forceinline__ T col(const T* __restrict__ cols, int row, int c) {
  return cols[row * N_COLS + c];
}

__device__ __forceinline__ int jprev(int j, int n) { return j == 0 ? n - 1 : j - 1; }
__device__ __forceinline__ int jnext(int j, int n) { return j == n - 1 ? 0 : j + 1; }

// (a mod n) in [0, n) for any sign of a; C++ % keeps the sign of a.
__device__ __forceinline__ int wrap(int a, int n) { return ((a % n) + n) % n; }

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

template <typename T>
__device__ __forceinline__ T van_leer(T a, T b) {
  T p = a * b;
  return p > T(0) ? T(2) * p / (a + b) : T(0);
}

template <typename T>
__device__ __forceinline__ T minmod(T a, T b) {
  return a * b > T(0) ? (fabs(a) < fabs(b) ? a : b) : T(0);
}

template <typename T>
__device__ __forceinline__ T limiter(T a, T b, int kind) {
  if (kind == 1) return minmod(T(0.5) * (a + b), T(2) * minmod(a, b));
  return van_leer(a, b);
}

// max/min that carry a NaN through, as the tensor reductions do
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (b > a || b != b) ? b : a; }
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (b < a || b != b) ? b : a; }

struct MaxOp {
  template <typename T> __device__ T operator()(T a, T b) const { return nan_max(a, b); }
};
struct MinOp {
  template <typename T> __device__ T operator()(T a, T b) const { return nan_min(a, b); }
};
struct SumOp {
  template <typename T> __device__ T operator()(T a, T b) const { return a + b; }
};

// Block-wide reduction; blockDim.x must be a multiple of 32 (<= 1024).
// The result is valid in thread 0.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T identity) {
  __shared__ T warp_vals[32];
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // a previous reduction in this block has read warp_vals
  if (lane == 0) warp_vals[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  if (warp == 0) {
    v = lane < n_warps ? warp_vals[lane] : identity;
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

inline unsigned int n_blocks(size_t n_threads) {
  return (unsigned int)((n_threads + BLOCK - 1) / BLOCK);
}

}  // namespace fc
