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
// cell in f32 for K = 6). Design: a copy with an index offset, one thread
// per value (k, i, j); the writes of a warp are contiguous and its reads
// are contiguous too, displaced by the ring's shift (split in two where
// the ring wraps), so both sides coalesce. One value per thread, no
// vector loads: a shift is rarely a multiple of four cells, so the reads
// of a 16-byte store would not be aligned.
#include "common.cuh"

namespace fc {
namespace {

template <typename T>
__global__ void advect_shift_kernel(const T* __restrict__ q,
                                    const int* __restrict__ nshift, int nr,
                                    int naz, size_t n, T* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int j = (int)(idx % naz);
  const size_t ring = idx / naz;                 // k * NR + i
  const int i = (int)(ring % nr);
  out[idx] = q[ring * naz + wrap(j - wrap(nshift[i], naz), naz)];
}

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  (void)fp;
  const int nr = ip[0], naz = ip[1], K = ip[2];
  const size_t n = (size_t)K * nr * naz;
  advect_shift_kernel<T><<<n_blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const T*)p[0], (const int*)p[1], nr, naz, n, (T*)p[2]);
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
