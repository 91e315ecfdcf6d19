// The azimuthal half of the split transport route: the residual sweep, the
// uniform sweep (fast transport only) and the per-ring integer roll.
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `fargo_theta_pallas` / `_fargo_theta_kernel` (reference
// src/TransportEuler.cpp:171-268 OneWindTheta + UniformTransport +
// AdvectSHIFT). Input and output: the batch (K, NR, NAZ), entry K-1 the
// density; vres (NR, NAZ) is the residual velocity (with vconst folded in
// when there is one sweep), vconst (NR) the uniform residual, nshift (NR)
// int32 the integer cell shift of each ring, of either sign.
//
// Bound: device memory. Least traffic: the batch and vres read once, the
// batch written once (52 B per cell in f32 for K = 6). Design: one launch
// of theta_sweep_kernel (transport.cuh, shared with theta_sweep.cu) per
// sweep, one thread per cell (i, j) that sweeps all K quantities:
//   two sweeps: qs -> scratch (residual velocity), scratch -> out
//               (uniform velocity, rolled);
//   one sweep:  qs -> out (residual velocity, rolled).
// The roll costs no pass of its own: the thread of the last sweep computes
// the swept value of the source cell (j - s_i) mod NAZ and writes it at j,
// so out[k, i, j] = swept[k, i, (j - s_i) mod NAZ], the meaning of
// advect_shift and of the TPU's lane rotate. The two-sweep route moves the
// batch through device memory twice; keeping the ring in shared memory
// (K NAZ values: 72 KB in f32, 144 KB in f64 at NAZ = 3072, above the
// 48 KB default) would save one pass and is later work.
//
// scal = [dt] on the device.
#include "transport.cuh"

namespace fc {
namespace {

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  const int nr = ip[0], naz = ip[1], K = ip[2], kind = ip[3];
  const int two_pass = ip[4];
  const T* qs = (const T*)p[0];
  const T* vres = (const T*)p[1];
  const T* vconst = (const T*)p[2];
  const int* nshift = (const int*)p[3];
  const T* cols = (const T*)p[4];
  const T* scal = (const T*)p[5];
  T* out = (T*)p[6];
  T* scratch = (T*)p[7];             // (K, NR, NAZ); unused with one sweep
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int blocks = n_blocks((size_t)nr * naz);
  if (two_pass) {
    theta_sweep_kernel<T><<<blocks, BLOCK, 0, s>>>(
        qs, vres, vconst, nshift, cols, scal, fp[0], nr, naz, K, kind, 0, 0,
        scratch);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    theta_sweep_kernel<T><<<blocks, BLOCK, 0, s>>>(
        scratch, vres, vconst, nshift, cols, scal, fp[0], nr, naz, K, kind, 1,
        1, out);
  } else {
    theta_sweep_kernel<T><<<blocks, BLOCK, 0, s>>>(
        qs, vres, vconst, nshift, cols, scal, fp[0], nr, naz, K, kind, 0, 1,
        out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

// ptrs: qs (K, NR, NAZ), vres, vconst (NR), nshift (NR, int32), cols, scal,
//       out (K, NR, NAZ), scratch (K, NR, NAZ)
// fp:   dphi
// ip:   NR, NAZ, K, flux limiter (0 van Leer, 1 MC), two_pass
extern "C" {
int fc_fargo_theta_f32(void* const* p, const double* fp, const int* ip,
                       void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_fargo_theta_f64(void* const* p, const double* fp, const int* ip,
                       void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
