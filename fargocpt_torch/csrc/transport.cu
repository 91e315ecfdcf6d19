// FARGO transport on the GPU.
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `transport_fused_pallas` / `_transport_kernel` (reference
// src/TransportEuler.cpp:112-685): momenta construction, the radial van
// Leer sweep of the K = 6 (adiabatic) or 5 advected quantities, the
// residual and uniform azimuthal sweeps (one sweep without fast
// transport), the per-ring integer shift and the velocity reconstruction,
// plus the radial mass flux through the faces.
//
// Bound: device memory. The batch of K quantities is the traffic: each
// sweep reads and writes K values per cell (48 B per cell in f32 for
// K = 6). Design: one launch per stage, the batch kept in two scratch
// buffers (K, NR, NAZ) that the stages ping-pong:
//   1. radial: momenta + radial sweep -> A, and the mass flux. A thread
//      re-derives the specific quantities of rows i-2..i+2 from the fields
//      and builds both face fluxes of its cell.
//   2. theta (x2 with fast transport): one azimuthal sweep A -> B, B -> A.
//      The stencil is j-2..j+2 along a ring, read through L1.
//   3. final: integer shift as an index offset (no extra copy of the
//      batch), then sigma, energy, vrad, vaz.
// Fusing the stages to keep the batch in shared memory is later work.
//
// The shift s_i = floor(ntilde + 0.5) and the residual velocity are inputs
// (computed once by the caller), so the kernel and the tensor version can
// be fed the same shift. scal = [dt, omega_frame] on the device.
#include "transport.cuh"

namespace fc {
namespace {

struct TrParams {
  double dphi;
  int adiabatic, limiter, fast;
};

template <typename T>
__global__ void tr_radial_kernel(const T* __restrict__ sigma,
                                 const T* __restrict__ vrad,
                                 const T* __restrict__ vaz,
                                 const T* __restrict__ energy,
                                 const T* __restrict__ cols,
                                 const T* __restrict__ scal, TrParams P,
                                 int nr, int naz, int K, T* __restrict__ qa,
                                 T* __restrict__ flux) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)nr * naz;
  if (idx >= plane) return;
  const int i = (int)(idx / naz);
  const int j = (int)(idx % naz);
  const T dt = scal[0];
  const T omega = scal[1];
  const int k_sigma = K - 1;
  const int f0 = i, f1 = i + 1;     // the two faces of cell i

  // density stars at both faces from sigma rows i-2..i+2
  T s[5];
  for (int d = 0; d < 5; ++d) s[d] = sigma[(size_t)clampi(i - 2 + d, 0, nr - 1) * naz + j];
  const T vr0 = vrad[idx], vr1 = vrad[idx + naz];
  const T ds0 = star_radial(s, f0, nr, vr0, dt, cols, P.limiter);
  const T ds1 = star_radial(s + 1, f1, nr, vr1, dt, cols, P.limiter);
  const T dtdphi = dt * T(P.dphi);
  const T ra0 = col(cols, f0, C_RA), ra1 = col(cols, f1, C_RA);
  const T inv_surf = col(cols, i, C_INV_SURF);

  for (int k = 0; k < K; ++k) {
    T w[5], q = T(0);
    radial_profile(sigma, vrad, vaz, energy, cols, omega, k, k_sigma, i, j,
                   nr, naz, w, q);
    const T st0 = star_radial(w, f0, nr, vr0, dt, cols, P.limiter);
    const T st1 = star_radial(w + 1, f1, nr, vr1, dt, cols, P.limiter);
    const T fl0 = dtdphi * ra0 * st0 * ds0 * vr0;
    const T fl1 = dtdphi * ra1 * st1 * ds1 * vr1;
    qa[(size_t)k * plane + idx] = q + (fl0 - fl1) * inv_surf;
    if (k == k_sigma) {
      flux[idx] = fl0;
      if (i == nr - 1) flux[idx + naz] = T(0);
    }
  }
}

// mode 0: v = vaz - vmean; 1: v = vconst; 2: v = vaz - vmean + vconst
template <typename T>
__device__ __forceinline__ T sweep_velocity(const T* __restrict__ vaz,
                                            const T* __restrict__ vmean,
                                            const T* __restrict__ vconst,
                                            int mode, int i, int j, int naz) {
  if (mode == 1) return vconst[i];
  const T vres = vaz[(size_t)i * naz + j] - vmean[i];
  return mode == 2 ? vres + vconst[i] : vres;
}

template <typename T>
__global__ void tr_theta_kernel(const T* __restrict__ qin,
                                const T* __restrict__ vaz,
                                const T* __restrict__ vmean,
                                const T* __restrict__ vconst,
                                const T* __restrict__ cols,
                                const T* __restrict__ scal, TrParams P,
                                int nr, int naz, int K, int mode,
                                T* __restrict__ qout) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)nr * naz;
  if (idx >= plane) return;
  const int i = (int)(idx / naz);
  const int j = (int)(idx % naz);
  int jj[5];                         // cells j-2 .. j+2
  for (int d = 0; d < 5; ++d) jj[d] = wrap(j - 2 + d, naz);
  const T v0 = sweep_velocity(vaz, vmean, vconst, mode, i, j, naz);
  const T v1 = sweep_velocity(vaz, vmean, vconst, mode, i, jj[3], naz);
  theta_sweep_cell(qin, cols, K, nr, naz, i, jj, v0, v1, scal[0], T(P.dphi),
                   P.limiter, qout, idx);
}

template <typename T>
__global__ void tr_final_kernel(const T* __restrict__ q,
                                const int* __restrict__ nshift,
                                const T* __restrict__ vrad,
                                const T* __restrict__ energy,
                                const T* __restrict__ cols,
                                const T* __restrict__ scal, TrParams P,
                                int nr, int naz, int K,
                                T* __restrict__ sigma_out,
                                T* __restrict__ vrad_out,
                                T* __restrict__ vaz_out,
                                T* __restrict__ energy_out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)nr * naz;
  if (idx >= (size_t)(nr + 1) * naz) return;
  const int i = (int)(idx / naz);
  const int j = (int)(idx % naz);
  if (i == nr) {
    vrad_out[idx] = vrad[idx];
    return;
  }
  const T* sig = q + (size_t)(K - 1) * plane;
  // shifted ring: out[i, j] = in[i, (j - s_i) mod NAZ]
  const int si = wrap(nshift[i], naz);
  const size_t src = (size_t)i * naz + wrap(j - si, naz);
  const size_t srcm = (size_t)i * naz + wrap(j - 1 - si, naz);
  const T s_here = sig[src];
  sigma_out[idx] = s_here;
  energy_out[idx] = P.adiabatic ? q[4 * plane + src] : energy[idx];
  const T omega = scal[1];
  const T rb = col(cols, i, C_RB);
  vaz_out[idx] = (q[2 * plane + srcm] + q[3 * plane + src]) / (sig[srcm] + s_here) *
                     col(cols, i, C_INV_RB) - rb * omega;
  if (i == 0) {
    vrad_out[idx] = T(0);
  } else {
    const int sl = wrap(nshift[i - 1], naz);
    const size_t src_lo = (size_t)(i - 1) * naz + wrap(j - sl, naz);
    vrad_out[idx] = (q[src_lo] + q[plane + src]) / (sig[src_lo] + s_here);
  }
}

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  TrParams P{fp[0], ip[2], ip[3], ip[4]};
  const int nr = ip[0], naz = ip[1];
  const int K = P.adiabatic ? 6 : 5;
  const T* sigma = (const T*)p[0];
  const T* vrad = (const T*)p[1];
  const T* vaz = (const T*)p[2];
  const T* energy = (const T*)p[3];
  const T* cols = (const T*)p[4];
  const T* scal = (const T*)p[5];
  const T* vmean = (const T*)p[6];
  const int* nshift = (const int*)p[7];
  const T* vconst = (const T*)p[8];
  T* sigma_out = (T*)p[9];
  T* vrad_out = (T*)p[10];
  T* vaz_out = (T*)p[11];
  T* energy_out = (T*)p[12];
  T* flux = (T*)p[13];
  T* qa = (T*)p[14];     // scratch (K, NR, NAZ)
  T* qb = (T*)p[15];     // scratch (K, NR, NAZ)
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n_cell = (size_t)nr * naz, n_face = (size_t)(nr + 1) * naz;
  tr_radial_kernel<T><<<n_blocks(n_cell), BLOCK, 0, s>>>(
      sigma, vrad, vaz, energy, cols, scal, P, nr, naz, K, qa, flux);
  const T* result = qb;
  if (P.fast) {
    tr_theta_kernel<T><<<n_blocks(n_cell), BLOCK, 0, s>>>(
        qa, vaz, vmean, vconst, cols, scal, P, nr, naz, K, 0, qb);
    tr_theta_kernel<T><<<n_blocks(n_cell), BLOCK, 0, s>>>(
        qb, vaz, vmean, vconst, cols, scal, P, nr, naz, K, 1, qa);
    result = qa;
  } else {
    tr_theta_kernel<T><<<n_blocks(n_cell), BLOCK, 0, s>>>(
        qa, vaz, vmean, vconst, cols, scal, P, nr, naz, K, 2, qb);
  }
  tr_final_kernel<T><<<n_blocks(n_face), BLOCK, 0, s>>>(
      result, nshift, vrad, energy, cols, scal, P, nr, naz, K, sigma_out,
      vrad_out, vaz_out, energy_out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

extern "C" {
int fc_transport_f32(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_transport_f64(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
