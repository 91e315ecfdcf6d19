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
// cells' lower interfaces, read per cell.
//
// Bound: device memory. Least traffic: the batch and v read once, the
// batch written once (52 B per cell in f32 for K = 6). Design: one launch
// of the ring-tile kernel of transport.cuh (theta_ring_kernel, shared with
// fargo_theta.cu) with one sweep and no roll: a block holds 512 output
// cells of a ring (256 in f64) and a halo of 2 each way in shared memory,
// derives each quotient by the density once and each interface's upwind
// value once, with the upwind slope only.
//
// scal = [dt] on the device.
#include "transport.cuh"

namespace fc {
namespace {

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  return launch_theta_ring<T>((const T*)p[0], (const T*)p[1], nullptr,
                              nullptr, (const T*)p[2], (const T*)p[3], fp[0],
                              ip[0], ip[1], ip[2], ip[3], 1, (T*)p[4],
                              (cudaStream_t)stream);
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
