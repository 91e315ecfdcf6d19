// The azimuthal half of the split transport route: the residual sweep, the
// uniform sweep (fast transport only) and the per-ring integer roll.
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `fargo_theta_pallas` / `_fargo_theta_kernel` (reference
// src/TransportEuler.cpp:171-268 OneWindTheta + UniformTransport +
// AdvectSHIFT). Input and output: the batch (K, NR, NAZ), entry K-1 the
// density; vres (NR, NAZ) is the residual velocity (with vconst folded in
// when there is one sweep), vconst (NR) the uniform residual, nshift (NR)
// int32 the integer cell shift of each ring, of either sign and any size.
//
// Bound: device memory. Least traffic: the batch and vres read once, the
// batch written once (52 B per cell in f32 for K = 6). Design: one launch
// of the ring-tile kernel of transport.cuh (theta_ring_kernel, shared with
// theta_sweep.cu), with both sweeps in it when there are two: a block
// loads its tile of source cells with a halo of 2 cells a sweep each way
// into shared memory, at its shifted place (source cell j - s_i for
// output cell j), sweeps it with the residual velocity, then with the
// ring's uniform vconst and the once-swept density, and writes it out, so
// out[k, i, j] = swept[k, i, (j - s_i) mod NAZ], the meaning of
// advect_shift and of the TPU's lane rotate. The batch does not pass
// through device memory between the sweeps.
//
// scal = [dt] on the device.
#include "transport.cuh"

namespace fc {
namespace {

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  return launch_theta_ring<T>((const T*)p[0], (const T*)p[1], (const T*)p[2],
                              (const int*)p[3], (const T*)p[4],
                              (const T*)p[5], fp[0], ip[0], ip[1], ip[2],
                              ip[3], ip[4] ? 2 : 1, (T*)p[6],
                              (cudaStream_t)stream);
}

}  // namespace
}  // namespace fc

// ptrs: qs (K, NR, NAZ), vres, vconst (NR), nshift (NR, int32), cols, scal,
//       out (K, NR, NAZ)
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
