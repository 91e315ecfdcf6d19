// One azimuthal van Leer / MC sweep of the advected batch: a stage of the
// staged transport route (two calls a step with fast transport: the
// residual velocity, then the uniform velocity expanded to (NR, NAZ); one
// call without).
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `theta_sweep_pallas` / `_theta_sweep_kernel` (reference
// src/TransportEuler.cpp:630-664 VanLeerTheta with :416-466
// compute_star_theta). Input and output: the batch (K, NR, NAZ), any
// K >= 1, entry K-1 the density: every quantity is divided by it and
// advected with its upwind value; v (NR, NAZ) is the sweep velocity at the
// cells' lower interfaces.
//
// Bound: device memory. Least traffic: the batch and v read once, the
// batch written once (52 B per cell in f32 for K = 6). Design: the ring
// sweep of fargo_theta.cu without its roll and its uniform velocity, one
// launch of the same kernel (theta_sweep_kernel in transport.cuh): one
// thread per cell (i, j) sweeps all K quantities, reading the five
// neighbours j-2..j+2 of each plane; neighbouring threads read
// neighbouring addresses, and the reuse of the stencil is left to L1.
//
// scal = [dt] on the device.
#include "transport.cuh"

namespace fc {
namespace {

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  const int nr = ip[0], naz = ip[1], K = ip[2], kind = ip[3];
  theta_sweep_kernel<T>
      <<<n_blocks((size_t)nr * naz), BLOCK, 0, (cudaStream_t)stream>>>(
          (const T*)p[0], (const T*)p[1], nullptr, nullptr, (const T*)p[2],
          (const T*)p[3], fp[0], nr, naz, K, kind, 0, 0, (T*)p[4]);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

// ptrs: qs (K, NR, NAZ), v (NR, NAZ), cols, scal, out (K, NR, NAZ)
// fp:   dphi
// ip:   NR, NAZ, K, flux limiter (0 van Leer, 1 MC)
extern "C" {
int fc_theta_sweep_f32(void* const* p, const double* fp, const int* ip,
                       void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_theta_sweep_f64(void* const* p, const double* fp, const int* ip,
                       void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
