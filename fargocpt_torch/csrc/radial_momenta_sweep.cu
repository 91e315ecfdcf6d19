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
// per cell in f32 for K = 6). Design: one thread per output value
// (k, i, j), so neighbouring threads read neighbouring columns. A thread
// rebuilds the specific value of quantity k in rows i-2..i+2 from the
// primitive fields (the momenta never exist in device memory, as in the
// TPU kernel), takes the limited upwind values at faces i and i+1, and
// writes q + (F_i - F_{i+1}) inv_surf with F_f = star_f * base_f. The flux
// is zero at faces 0 and NR and the slope zero in rows 0 and NR-1
// (star_radial). The K threads of one cell re-read the same rows; L1 and
// L2 absorb that, and keeping a tile of rows in shared memory is later
// work.
//
// scal = [dt, omega_frame] on the device.
#include "transport.cuh"

namespace fc {
namespace {

template <typename T>
__global__ void rms_kernel(const T* __restrict__ sigma,
                           const T* __restrict__ vrad,
                           const T* __restrict__ vaz,
                           const T* __restrict__ energy,
                           const T* __restrict__ base,
                           const T* __restrict__ cols,
                           const T* __restrict__ scal, int nr, int naz, int K,
                           int kind, T* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)nr * naz;
  if (idx >= (size_t)K * plane) return;
  const int k = (int)(idx / plane);
  const size_t cell = idx % plane;
  const int i = (int)(cell / naz);
  const int j = (int)(cell % naz);
  const T dt = scal[0];
  const T omega = scal[1];

  T w[5], q = T(0);
  radial_profile(sigma, vrad, vaz, energy, cols, omega, k, K - 1, i, j, nr,
                 naz, w, q);
  const T st0 = star_radial(w, i, nr, vrad[cell], dt, cols, kind);
  const T st1 = star_radial(w + 1, i + 1, nr, vrad[cell + naz], dt, cols, kind);
  const T fl0 = st0 * base[cell];
  const T fl1 = st1 * base[cell + naz];
  out[idx] = q + (fl0 - fl1) * col(cols, i, C_INV_SURF);
}

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  (void)fp;
  const int nr = ip[0], naz = ip[1];
  const int K = ip[2] ? 6 : 5;
  const int kind = ip[3];
  const size_t n = (size_t)K * nr * naz;
  rms_kernel<T><<<n_blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], nr, naz, K, kind,
      (T*)p[7]);
  return (int)cudaGetLastError();
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
