// The FARGO integer roll: each ring of the batch moved by its own whole
// number of cells, out[k, i, j] = q[k, i, (j - s_i) mod NAZ]. A stage of
// the staged transport route (one call a step).
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `advect_shift_pallas` / `_shift_kernel` (reference
// src/TransportEuler.cpp:238-268 AdvectSHIFT). The shift s_i (int32, NR)
// may be negative or beyond NAZ. No arithmetic on the values: the result
// equals the gather bit for bit.
//
// Bound: device memory, the batch read once and written once (48 B per
// cell in f32 for K = 6). One 4-byte value a thread, each with two 64-bit
// and two 32-bit integer divisions for its indices and its own read of the
// shift, reaches 39% of the memory rate of an H100 and loses to
// torch.gather, which reads an index as large as the batch besides: what
// costs is index arithmetic and narrow accesses, not bytes.
// Design: one block per ring (k, i), so the shift is wrapped once a thread
// before its loop and no cell divides. With s_i = VEC a + b (VEC = 4 values
// in float32, 2 in float64: 16 bytes), the output vector t is made of the
// aligned source vectors t - a - 1 and t - a: two aligned 16-byte loads
// (neighbouring threads share one of them through L1; one load when
// b = 0), a choice of lanes that is uniform over the block, one aligned
// 16-byte store. Where NAZ is not a multiple of VEC or a pointer is not
// 16-byte aligned, the launch function takes the scalar kernel: the same
// block per ring, one value at a time, wrapped by compare and add.
#include <cstdint>

#include "common.cuh"

namespace fc {
namespace {

template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
  // out[e] = (lo ++ hi)[4 - b + e]
  static __device__ __forceinline__ float4 join(float4 lo, float4 hi, int b) {
    if (b == 1) return make_float4(lo.w, hi.x, hi.y, hi.z);
    if (b == 2) return make_float4(lo.z, lo.w, hi.x, hi.y);
    return make_float4(lo.y, lo.z, lo.w, hi.x);
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
  static __device__ __forceinline__ double2 join(double2 lo, double2 hi, int) {
    return make_double2(lo.y, hi.x);
  }
};

template <typename T>
__global__ void advect_shift_vec_kernel(const T* __restrict__ q,
                                        const int* __restrict__ nshift,
                                        int nr, int naz, T* __restrict__ out) {
  using V = typename Vec<T>::type;
  constexpr int VEC = Vec<T>::width;
  const size_t ring = blockIdx.x;                // k * NR + i
  const int s = wrap(nshift[blockIdx.x % nr], naz);
  const int a = s / VEC, b = s % VEC;
  const int n_vec = naz / VEC;
  const V* __restrict__ src = reinterpret_cast<const V*>(q + ring * naz);
  V* __restrict__ dst = reinterpret_cast<V*>(out + ring * naz);
  for (int t = threadIdx.x; t < n_vec; t += blockDim.x) {
    int u = t - a;
    if (u < 0) u += n_vec;
    const V hi = src[u];
    if (b == 0) {
      dst[t] = hi;
    } else {
      dst[t] = Vec<T>::join(src[u == 0 ? n_vec - 1 : u - 1], hi, b);
    }
  }
}

template <typename T>
__global__ void advect_shift_scalar_kernel(const T* __restrict__ q,
                                           const int* __restrict__ nshift,
                                           int nr, int naz,
                                           T* __restrict__ out) {
  const size_t ring = blockIdx.x;                // k * NR + i
  const int s = wrap(nshift[blockIdx.x % nr], naz);
  const T* __restrict__ src = q + ring * naz;
  T* __restrict__ dst = out + ring * naz;
  for (int j = threadIdx.x; j < naz; j += blockDim.x) {
    const int c = j - s;
    dst[j] = src[c < 0 ? c + naz : c];
  }
}

// threads per block for `work` items a ring: a multiple of 32 up to BLOCK
inline int block_for(int work) {
  const int b = (work + 31) / 32 * 32;
  return b < 32 ? 32 : (b > BLOCK ? BLOCK : b);
}

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  (void)fp;
  const int nr = ip[0], naz = ip[1], K = ip[2];
  const T* q = (const T*)p[0];
  const int* nshift = (const int*)p[1];
  T* out = (T*)p[2];
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int rings = (unsigned int)K * (unsigned int)nr;
  constexpr int VEC = Vec<T>::width;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (aligned && naz % VEC == 0) {
    advect_shift_vec_kernel<T><<<rings, block_for(naz / VEC), 0, s>>>(
        q, nshift, nr, naz, out);
  } else {
    advect_shift_scalar_kernel<T><<<rings, block_for(naz), 0, s>>>(
        q, nshift, nr, naz, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

// ptrs: qs (K, NR, NAZ), nshift (NR, int32), out (K, NR, NAZ)
// ip:   NR, NAZ, K
extern "C" {
int fc_advect_shift_f32(void* const* p, const double* fp, const int* ip,
                        void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_advect_shift_f64(void* const* p, const double* fp, const int* ip,
                        void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
