// Momenta construction + radial van Leer sweep of the split transport
// route.
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `radial_momenta_sweep_pallas` / `_radial_momenta_kernel` (reference
// src/TransportEuler.cpp:471-493 compute_momenta_from_velocities fused with
// :545-620 VanLeerRadial). Output: the radially transported batch
// (K, NR, NAZ), ordered [rp, rm, ap, am, (energy), sigma].
//
// Bound: device memory. Least traffic: sigma, vaz, energy (NR, NAZ), vrad
// and the sigma flux `base` (NR+1, NAZ) read once, K planes written (44 B
// per cell in f32 for K = 6). Design: one launch of the column march of
// transport.cuh (radial_march_kernel with the MarchFields source): a
// thread marches up a strip of rows of its column, builds each row's
// momenta and their quotients by sigma once in registers (the momenta never
// exist in device memory, as in the TPU kernel), and evaluates each face's
// flux once with the upwind slope only.
//
// scal = [dt, omega_frame] on the device.
#include "transport.cuh"

namespace fc {
namespace {

template <typename T, int K>
int run(void* const* p, int nr, int naz, int kind, cudaStream_t stream) {
  const MarchFields<T, K> src{(const T*)p[0], (const T*)p[1], (const T*)p[2],
                              (const T*)p[3], (const T*)p[5], T(0)};
  return launch_radial_march<T, K>(src, (const T*)p[1], (const T*)p[4],
                                   (const T*)p[5], (const T*)p[6], nr, naz, K,
                                   kind, (T*)p[7], stream);
}

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  (void)fp;
  const int nr = ip[0], naz = ip[1], kind = ip[3];
  cudaStream_t s = (cudaStream_t)stream;
  return ip[2] ? run<T, 6>(p, nr, naz, kind, s) : run<T, 5>(p, nr, naz, kind, s);
}

}  // namespace
}  // namespace fc

// ptrs: sigma, vrad, vaz, energy, base, cols, scal, out (K, NR, NAZ)
// ip:   NR, NAZ, adiabatic, flux limiter (0 van Leer, 1 MC)
extern "C" {
int fc_radial_momenta_sweep_f32(void* const* p, const double* fp,
                                const int* ip, void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_radial_momenta_sweep_f64(void* const* p, const double* fp,
                                const int* ip, void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
