// Stone & Norman artificial viscosity substep.
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `artvisc_sn_pallas` / `_artvisc_sn_kernel` (reference
// src/viscosity/artificial_viscosity.cpp:148-250); the plain version is
// fargocpt_torch/ops/artvisc.py `update_sn`. With the pressures
//   q_r   = c2 sigma dv_r^2    where dv_r   = v_rad[i+1] - v_rad[i] < 0,
//   q_phi = c2 sigma dv_phi^2  where dv_phi = v_az[j+1] - v_az[j] < 0,
// it writes
//   energy rows 1..NR-2: e - dt q_r dv_r / (Rsup - Rinf)
//                          - dt q_phi dv_phi / (Rmed dphi)  (dissipation on)
//   v_rad faces 2..NR-2: v_rad - dt 2/(sigma_i + sigma_{i-1})
//                          (q_r,i - q_r,i-1) / (Rmed_i - Rmed_{i-1})
//   v_az rows 1..NR-2:   v_az - dt 2/(sigma_j + sigma_{j-1})
//                          (q_phi,j - q_phi,j-1) / (Rmed dphi)
// and copies every other row. Azimuth is periodic.
//
// Bound: device memory. Least traffic: sigma, v_az, energy (NR, NAZ) and
// v_rad (NR+1, NAZ) read once, v_rad, v_az, energy written once (28 B per
// cell in f32). Design: one thread per face-row cell (i, j) of the
// (NR+1, NAZ) grid; it writes v_rad[i, j] and, for i < NR, v_az[i, j] and
// energy[i, j]. Neighbouring threads take neighbouring columns, so every
// load and store is coalesced; the pressures of the neighbour cells
// (i-1, j) and (i, j-1) are recomputed from the fields instead of kept in
// device memory, and the re-read rows come from L1/L2. The TPU kernel's
// neighbour-block halo reads (a lane-tiling device of Mosaic) have no
// counterpart here.
//
// The arithmetic follows the plain version operation by operation (nvcc
// runs with --fmad=false), so the two agree to rounding.
//
// scal = [dt] on the device.
#include "common.cuh"

namespace fc {
namespace {

template <typename T>
__device__ __forceinline__ T pressure(T c2, T sig, T dv) {
  return dv < T(0) ? c2 * sig * (dv * dv) : T(0);
}

template <typename T>
__global__ void artvisc_sn_kernel(const T* __restrict__ sigma,
                                  const T* __restrict__ vrad,
                                  const T* __restrict__ vaz,
                                  const T* __restrict__ energy,
                                  const T* __restrict__ cols,
                                  const T* __restrict__ scal, T c2,
                                  T invdphi, int nr, int naz,
                                  int dissipation, T* __restrict__ vrad_out,
                                  T* __restrict__ vaz_out,
                                  T* __restrict__ e_out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)(nr + 1) * naz) return;
  const int i = (int)(idx / naz);
  const int j = (int)(idx % naz);
  const T dt = scal[0];

  // v_rad face i: the radial pressures of cells i and i-1
  T vr = vrad[idx];
  if (i >= 2 && i <= nr - 2) {
    const T dv_lo = vrad[idx] - vrad[idx - naz];
    const T dv_hi = vrad[idx + naz] - vrad[idx];
    const T s_lo = sigma[idx - naz];
    const T s_hi = sigma[idx];
    const T q_lo = pressure(c2, s_lo, dv_lo);
    const T q_hi = pressure(c2, s_hi, dv_hi);
    const T dvr = -dt * T(2) / (s_hi + s_lo) * (q_hi - q_lo) *
                  col(cols, i, C_INVDRM);
    vr = vr + dvr;
  }
  vrad_out[idx] = vr;
  if (i >= nr) return;

  const T v = vaz[idx];
  const T e = energy[idx];
  if (i < 1 || i > nr - 2) {
    vaz_out[idx] = v;
    e_out[idx] = e;
    return;
  }
  const size_t row = (size_t)i * naz;
  const int jp = jprev(j, naz);
  const int jn = jnext(j, naz);
  const T s = sigma[idx];
  const T s_m = sigma[row + jp];
  const T dv_phi = vaz[row + jn] - v;
  const T dv_phi_m = v - vaz[row + jp];
  const T q_phi = pressure(c2, s, dv_phi);
  const T q_phi_m = pressure(c2, s_m, dv_phi_m);
  const T invdxtheta = col(cols, i, C_INV_RB) * invdphi;

  if (dissipation) {
    const T dv_r = vrad[idx + naz] - vrad[idx];
    const T q_r = pressure(c2, s, dv_r);
    e_out[idx] = e - dt * q_r * dv_r * col(cols, i, C_INV_DIFF_RSUP) -
                 dt * q_phi * dv_phi * invdxtheta;
  } else {
    e_out[idx] = e;
  }
  const T dvaz = -dt * T(2) / (s + s_m) * (q_phi - q_phi_m) * invdxtheta;
  vaz_out[idx] = v + dvaz;
}

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  const int nr = ip[0], naz = ip[1];
  const size_t n = (size_t)(nr + 1) * naz;
  artvisc_sn_kernel<T><<<n_blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (T)fp[0], (T)fp[1], nr, naz, ip[2],
      (T*)p[6], (T*)p[7], (T*)p[8]);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

// ptrs: sigma, vrad, vaz, energy, cols, scal, vrad_out, vaz_out, e_out
// fp:   c2 (ArtificialViscosityFactor^2), 1/dphi
// ip:   NR, NAZ, dissipation (adiabatic and ArtificialViscosityDissipation)
extern "C" {
int fc_artvisc_sn_f32(void* const* p, const double* fp, const int* ip,
                      void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_artvisc_sn_f64(void* const* p, const double* fp, const int* ip,
                      void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
