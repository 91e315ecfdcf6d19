// Radial van Leer / MC sweep of a given batch with the sigma flux `base`:
// a stage of the staged transport route (one call a step).
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `radial_sweep_pallas` / `_radial_sweep_kernel` (reference
// src/TransportEuler.cpp:545-620 VanLeerRadial with :349-406
// compute_star_radial). Input: the batch qs (K, NR, NAZ) of any K and any
// contents, the pre-sweep density sigma (NR, NAZ) that every entry is
// divided by, the face velocity vrad and the sigma flux
// base = dt dphi Ra density_star vrad, both (NR+1, NAZ). Output: the swept
// batch, out = qs + (F_i - F_{i+1}) inv_surf with F_f = star_f(qs / sigma)
// base_f. Unlike radial_momenta_sweep.cu the batch is read, not rebuilt
// from the fields, and the density entry is swept like the others
// (sigma / sigma = 1, so its upwind value is 1 on the interior faces).
//
// Bound: device memory. Least traffic: the batch, sigma, vrad and base read
// once, the batch written once (60 B per cell in f32 for K = 6). Design:
// one thread per cell (i, j) that sweeps all K quantities, so sigma's five
// rows i-2..i+2, the two face velocities and the two fluxes are read once
// per cell and not once per quantity; neighbouring threads read
// neighbouring columns, and the five-row reuse between the threads of a
// column is left to L1 and L2. The flux is zero at faces 0 and NR and the
// slope zero in rows 0 and NR-1 (star_radial in transport.cuh); rows
// outside the grid are clamped and never enter a slope that is used.
//
// scal = [dt] on the device.
#include "transport.cuh"

namespace fc {
namespace {

template <typename T>
__global__ void radial_sweep_kernel(const T* __restrict__ qs,
                                    const T* __restrict__ sigma,
                                    const T* __restrict__ vrad,
                                    const T* __restrict__ base,
                                    const T* __restrict__ cols,
                                    const T* __restrict__ scal, int nr,
                                    int naz, int K, int kind,
                                    T* __restrict__ out) {
  const size_t cell = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)nr * naz;
  if (cell >= plane) return;
  const int i = (int)(cell / naz);
  const int j = (int)(cell % naz);
  const T dt = scal[0];

  size_t at[5];                      // rows i-2 .. i+2 of column j
  T sig[5];
  for (int d = 0; d < 5; ++d) {
    at[d] = (size_t)clampi(i - 2 + d, 0, nr - 1) * naz + j;
    sig[d] = sigma[at[d]];
  }
  const T vr0 = vrad[cell], vr1 = vrad[cell + naz];
  const T b0 = base[cell], b1 = base[cell + naz];
  const T inv_surf = col(cols, i, C_INV_SURF);

  for (int k = 0; k < K; ++k) {
    const T* qk = qs + (size_t)k * plane;
    T w[5];
    for (int d = 0; d < 5; ++d) w[d] = qk[at[d]] / sig[d];
    const T st0 = star_radial(w, i, nr, vr0, dt, cols, kind);
    const T st1 = star_radial(w + 1, i + 1, nr, vr1, dt, cols, kind);
    out[(size_t)k * plane + cell] = qk[cell] + (st0 * b0 - st1 * b1) * inv_surf;
  }
}

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  (void)fp;
  const int nr = ip[0], naz = ip[1], K = ip[2], kind = ip[3];
  radial_sweep_kernel<T>
      <<<n_blocks((size_t)nr * naz), BLOCK, 0, (cudaStream_t)stream>>>(
          (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
          (const T*)p[4], (const T*)p[5], nr, naz, K, kind, (T*)p[6]);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

// ptrs: qs (K, NR, NAZ), sigma, vrad, base, cols, scal, out (K, NR, NAZ)
// ip:   NR, NAZ, K, flux limiter (0 van Leer, 1 MC)
extern "C" {
int fc_radial_sweep_f32(void* const* p, const double* fp, const int* ip,
                        void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_radial_sweep_f64(void* const* p, const double* fp, const int* ip,
                        void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
