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
// one launch of the column march of transport.cuh (radial_march_kernel with
// the MarchBatch source): a thread marches up a strip of rows of its
// column with all K planes at once for K = 5 and 6, one plane at a time for
// any other K; each quotient by sigma is made once and each face's flux
// once, with the upwind slope only.
//
// scal = [dt] on the device.
#include "transport.cuh"

namespace fc {
namespace {

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  (void)fp;
  const int nr = ip[0], naz = ip[1], K = ip[2], kind = ip[3];
  const MarchBatch<T> src{(const T*)p[0], (const T*)p[1]};
  const T* vrad = (const T*)p[2];
  const T* base = (const T*)p[3];
  const T* cols = (const T*)p[4];
  const T* scal = (const T*)p[5];
  T* out = (T*)p[6];
  cudaStream_t s = (cudaStream_t)stream;
  auto march = K == 6 ? launch_radial_march<T, 6, MarchBatch<T>>
               : K == 5 ? launch_radial_march<T, 5, MarchBatch<T>>
                        : launch_radial_march<T, 0, MarchBatch<T>>;
  return march(src, vrad, base, cols, scal, nr, naz, K, kind, out, s);
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
