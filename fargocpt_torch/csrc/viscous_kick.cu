// Viscous kick on the GPU: compression heating, artificial viscosity,
// Navier-Stokes viscosity and the SubStep3 energy update.
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `viscous_kick_pallas` / `_viscous_kick_kernel`. In order (reference
// line ranges in that kernel's header): compression heating, SN or TW
// artificial viscosity with dissipation, the temperature clamp,
// nu = alpha cs H, the viscous stress tensor, the velocity update, Q+
// viscous heating, local beta cooling Q-, the radiative correction factor,
// the near-floor equilibrium, the energy update and the clamp.
//
// Bound: device memory. The chain is a sequence of 3x3 stencils; done as
// separate tensor ops it moves the fields through device memory ~15 times.
// Design: three launches, each a one-thread-per-cell stencil whose
// neighbour reads mostly hit L1/L2:
//   1. artvisc: compression heating, artificial viscosity and the clamp,
//      from the input fields -> e1, vr1, va1. The artificial pressures of
//      the neighbouring cells are recomputed in place, not stored.
//   2. stress: nu (recomputed from e1 wherever needed), div v and the
//      stress tensor -> tau_rr, tau_pp, tau_rp, div_v.
//   3. update: velocity update from the stress divergence, Q+/Q-, energy.
// About 4 + 7 + 7 values per cell cross device memory (vs ~15 passes of
// 4 fields). Scratch comes from the wrapper.
//
// Q+ at ring NR-1 would read tau_rp at row NR; both ghost rings of Q+/Q-
// are written as zero, as the reference's cleared grids are.
//
// scal = [dt, 1/beta] on the device.
#include "common.cuh"

namespace fc {
namespace {

struct VkParams {
  double gamma, alpha, const_nu, c2, heat_factor, rvf, tmin, tmax, mu, R,
      sigma_sb, c_light, sig_nf, invdphi;
  int adiabatic, artvisc, dissipation, compress, heating, beta_on;
};

template <typename T>
__device__ __forceinline__ void clamp_energy(T& e, T sig, const VkParams& P) {
  // energy_floor_ceiling: E in [Tmin, Tmax] * Sigma / mu * R / (gamma - 1)
  const T fac = sig / T(P.mu) * T(P.R) / T(P.gamma - 1.0);
  e = fmin(fmax(e, T(P.tmin) * fac), T(P.tmax) * fac);
}

// nu and H of one cell from its (post-artvisc) energy
template <typename T>
__device__ __forceinline__ void nu_h(const T* __restrict__ cols, int i, T e,
                                     T sig, const VkParams& P, T& nu, T& h) {
  T cs;
  if (P.adiabatic) {
    cs = sqrt(T(P.gamma * (P.gamma - 1.0)) * e / sig);
    h = cs / T(sqrt(P.gamma)) / col(cols, i, C_OMEGA_K);
  } else {
    cs = col(cols, i, C_CS_ISO);
    h = cs / col(cols, i, C_OMEGA_K);
  }
  nu = P.alpha > 0.0 ? T(P.alpha) * cs * h : T(P.const_nu);
}

// SN artificial pressures of cell (i, j) from the input velocities
template <typename T>
__device__ __forceinline__ void sn_q(const T* __restrict__ vrad,
                                     const T* __restrict__ vaz, T sig, int i,
                                     int j, int naz, T c2, T& q_r, T& q_phi,
                                     T& dv_r, T& dv_phi) {
  const size_t c = (size_t)i * naz + j;
  dv_r = vrad[c + naz] - vrad[c];
  dv_phi = vaz[(size_t)i * naz + jnext(j, naz)] - vaz[c];
  q_r = dv_r < T(0) ? c2 * sig * (dv_r * dv_r) : T(0);
  q_phi = dv_phi < T(0) ? c2 * sig * (dv_phi * dv_phi) : T(0);
}

// TW tensor artificial pressures of cell (i, j) from the input velocities
template <typename T>
__device__ __forceinline__ void tw_q(const T* __restrict__ vrad,
                                     const T* __restrict__ vaz,
                                     const T* __restrict__ cols, T sig, int i,
                                     int j, int naz, T invdphi, T& q_rr,
                                     T& q_pp, T& eps_rr, T& eps_pp, T& div) {
  const size_t c = (size_t)i * naz + j;
  const T vr0 = vrad[c], vr1 = vrad[c + naz];
  const T dva = vaz[(size_t)i * naz + jnext(j, naz)] - vaz[c];
  eps_rr = (vr1 - vr0) * col(cols, i, C_INV_DIFF_RSUP);
  eps_pp = col(cols, i, C_INV_RB) * (dva * invdphi + T(0.5) * (vr1 + vr0));
  div = fmin(eps_rr + eps_pp, T(0));
  const T lsq = col(cols, i, C_L_SQ);
  q_rr = lsq * sig * (-div) * (eps_rr - div / T(3));
  q_pp = lsq * sig * (-div) * (eps_pp - div / T(3));
}

template <typename T>
__global__ void vk_artvisc_kernel(const T* __restrict__ sigma,
                                  const T* __restrict__ vrad,
                                  const T* __restrict__ vaz,
                                  const T* __restrict__ energy,
                                  const T* __restrict__ cols,
                                  const T* __restrict__ scal, VkParams P,
                                  int nr, int naz, T* __restrict__ e1,
                                  T* __restrict__ vr1, T* __restrict__ va1) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)(nr + 1) * naz) return;
  const int i = (int)(idx / naz);
  const int j = (int)(idx % naz);
  if (i == nr) {                     // outermost face: untouched
    vr1[idx] = vrad[idx];
    return;
  }
  const T dt = scal[0];
  const T invdphi = T(P.invdphi);
  const T inv_rb = col(cols, i, C_INV_RB);
  const T sig = sigma[idx];
  T en = energy[idx];
  T vr = vrad[idx];
  T va = vaz[idx];
  const bool interior = i >= 1 && i <= nr - 2;
  const bool face = i >= 2 && i <= nr - 2;

  if (P.adiabatic && P.compress && i <= nr - 2) {
    const T div = (vrad[idx + naz] * col(cols, i + 1, C_RA) -
                   vr * col(cols, i, C_RA)) * col(cols, i, C_INV_DIFF_RSUP_RB) +
                  (vaz[(size_t)i * naz + jnext(j, naz)] - va) * invdphi * inv_rb;
    en = en * exp(T(-(P.gamma - 1.0)) * dt * div);
  }

  const int jp = jprev(j, naz);
  const size_t cp = (size_t)i * naz + jp;
  if (P.artvisc == 1) {
    const T c2 = T(P.c2);
    T q_r, q_phi, dv_r, dv_phi;
    sn_q(vrad, vaz, sig, i, j, naz, c2, q_r, q_phi, dv_r, dv_phi);
    const T invdxtheta = inv_rb * invdphi;
    if (P.adiabatic && P.dissipation && interior)
      en = en - dt * q_r * dv_r * col(cols, i, C_INV_DIFF_RSUP) -
           dt * q_phi * dv_phi * invdxtheta;
    if (face) {
      const T sig_lo = sigma[idx - naz];
      T qr_lo, qphi_lo, dvr_lo, dvphi_lo;
      sn_q(vrad, vaz, sig_lo, i - 1, j, naz, c2, qr_lo, qphi_lo, dvr_lo, dvphi_lo);
      vr = vr + -dt * T(2) / (sig + sig_lo) * (q_r - qr_lo) * col(cols, i, C_INVDRM);
    }
    if (interior) {
      const T sig_p = sigma[cp];
      T qr_p, qphi_p, dvr_p, dvphi_p;
      sn_q(vrad, vaz, sig_p, i, jp, naz, c2, qr_p, qphi_p, dvr_p, dvphi_p);
      va = va + -dt * T(2) / (sig + sig_p) * (q_phi - qphi_p) * invdxtheta;
    }
  } else if (P.artvisc == 2) {
    T q_rr, q_pp, eps_rr, eps_pp, div;
    tw_q(vrad, vaz, cols, sig, i, j, naz, invdphi, q_rr, q_pp, eps_rr, eps_pp, div);
    if (P.adiabatic && P.dissipation && face) {
      const T d = eps_rr - eps_pp;
      const T qplus = -col(cols, i, C_L_SQ) * div * sig / T(3) *
                      (eps_rr * eps_rr + eps_pp * eps_pp + d * d);
      en = en + qplus * dt;
    }
    if (interior) {
      const T sig_p = sigma[cp];
      T qrr_p, qpp_p, a, b, c;
      tw_q(vrad, vaz, cols, sig_p, i, jp, naz, invdphi, qrr_p, qpp_p, a, b, c);
      const T sig_phi = T(0.5) * (sig + sig_p);
      va = va + T(2) * dt / (col(cols, i, C_SUM_RS_RI) * sig_phi) *
                    (q_pp - qpp_p) * invdphi;
    }
    if (face) {
      const T sig_lo = sigma[idx - naz];
      T qrr_lo, qpp_lo, a, b, c;
      tw_q(vrad, vaz, cols, sig_lo, i - 1, j, naz, invdphi, qrr_lo, qpp_lo, a, b, c);
      const T rb = col(cols, i, C_RB), rb_lo = col(cols, i - 1, C_RB);
      const T sig_r = T(0.5) * (sig + sig_lo);
      vr = vr + T(P.rvf) * dt / sig_r * T(2) / (rb * rb - rb_lo * rb_lo) *
                    ((q_rr * rb - qrr_lo * rb_lo) -
                     T(0.5) * (q_pp + qpp_lo) * (rb - rb_lo));
    }
  }
  if (P.adiabatic && P.dissipation) clamp_energy(en, sig, P);
  e1[idx] = en;
  vr1[idx] = vr;
  va1[idx] = va;
}

template <typename T>
__global__ void vk_stress_kernel(const T* __restrict__ sigma,
                                 const T* __restrict__ e1,
                                 const T* __restrict__ vr1,
                                 const T* __restrict__ va1,
                                 const T* __restrict__ cols, VkParams P,
                                 int nr, int naz, T* __restrict__ trr,
                                 T* __restrict__ tpp, T* __restrict__ trp,
                                 T* __restrict__ divv) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)nr * naz) return;
  const int i = (int)(idx / naz);
  const int j = (int)(idx % naz);
  const T invdphi = T(P.invdphi);
  const T inv_rb = col(cols, i, C_INV_RB);
  const T sig = sigma[idx];
  T nu, h;
  nu_h(cols, i, e1[idx], sig, P, nu, h);
  const T vr0 = vr1[idx], vrn = vr1[idx + naz];
  const T dva = va1[(size_t)i * naz + jnext(j, naz)] - va1[idx];
  const T div = (vrn * col(cols, i + 1, C_RA) - vr0 * col(cols, i, C_RA)) *
                    col(cols, i, C_INV_DIFF_RSUP_RB) +
                dva * invdphi * inv_rb;
  const T drr = (vrn - vr0) * col(cols, i, C_INV_DIFF_RSUP);
  trr[idx] = T(2) * nu * sig * (drr - div / T(3));
  const T dpp = dva * invdphi * inv_rb + T(0.5) * (vrn + vr0) * inv_rb;
  tpp[idx] = T(2) * nu * sig * (dpp - div / T(3));
  divv[idx] = div;
  if (i == 0) {
    trp[idx] = T(0);
    return;
  }
  const int jp = jprev(j, naz);
  const size_t lo = idx - naz;                       // (i-1, j)
  const size_t pj = (size_t)i * naz + jp;            // (i, j-1)
  const size_t lopj = (size_t)(i - 1) * naz + jp;    // (i-1, j-1)
  const T dvazirdr = (va1[idx] * inv_rb - va1[lo] * col(cols, i - 1, C_INV_RB)) *
                     col(cols, i, C_INVDRM);
  const T dvrdphi = (vr0 - vr1[pj]) * invdphi;
  const T drp = col(cols, i, C_RA) * dvazirdr + dvrdphi * col(cols, i, C_INV_RA);
  T nu_lo, nu_p, nu_lop, hh;
  nu_h(cols, i - 1, e1[lo], sigma[lo], P, nu_lo, hh);
  nu_h(cols, i, e1[pj], sigma[pj], P, nu_p, hh);
  nu_h(cols, i - 1, e1[lopj], sigma[lopj], P, nu_lop, hh);
  const T nu4 = T(0.25) * (nu + nu_lo + nu_p + nu_lop);
  const T sig4 = T(0.25) * (sig + sigma[lo] + sigma[pj] + sigma[lopj]);
  trp[idx] = nu4 * sig4 * drp;
}

template <typename T>
__global__ void vk_update_kernel(const T* __restrict__ sigma,
                                 const T* __restrict__ e1,
                                 const T* __restrict__ vr1,
                                 const T* __restrict__ va1,
                                 const T* __restrict__ trr,
                                 const T* __restrict__ tpp,
                                 const T* __restrict__ trp,
                                 const T* __restrict__ divv,
                                 const T* __restrict__ cols,
                                 const T* __restrict__ scal, VkParams P,
                                 int nr, int naz, T* __restrict__ vrad_out,
                                 T* __restrict__ vaz_out,
                                 T* __restrict__ energy_out,
                                 T* __restrict__ qp_out,
                                 T* __restrict__ qm_out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)(nr + 1) * naz) return;
  const int i = (int)(idx / naz);
  const int j = (int)(idx % naz);
  if (i == nr) {
    vrad_out[idx] = vr1[idx];
    return;
  }
  const T dt = scal[0];
  const T invdphi = T(P.invdphi);
  const T sig = sigma[idx];
  const bool interior = i >= 1 && i <= nr - 2;
  const int jp = jprev(j, naz), jn = jnext(j, naz);

  // v_rad, faces 2..NR-2
  T vr = vr1[idx];
  if (i >= 2 && i <= nr - 2) {
    const size_t lo = idx - naz;
    const T rb = col(cols, i, C_RB), rb_lo = col(cols, i - 1, C_RB);
    const T sig_avg_r = T(0.5) * (sig + sigma[lo]);
    const T trp_n = trp[(size_t)i * naz + jn];
    vr = vr + dt / sig_avg_r * T(P.rvf) * T(2) / (rb + rb_lo) *
                  ((rb * trr[idx] - rb_lo * trr[lo]) * col(cols, i, C_INVDRM) +
                   (trp_n - trp[idx]) * invdphi - T(0.5) * (tpp[idx] + tpp[lo]));
  }
  vrad_out[idx] = vr;

  // v_az, rings 1..NR-2
  T va = va1[idx];
  if (interior) {
    const size_t pj = (size_t)i * naz + jp;
    const T sig_avg_phi = T(0.5) * (sig + sigma[pj]);
    const T ra = col(cols, i, C_RA), ra_n = col(cols, i + 1, C_RA);
    const T trp_rsq = ra * ra * trp[idx];
    const T trp_rsq_up = ra_n * ra_n * trp[idx + naz];
    va = va + dt * col(cols, i, C_INV_RB) / sig_avg_phi *
                  (col(cols, i, C_TWO_DIFF_RA_SQ) * (trp_rsq_up - trp_rsq) +
                   (tpp[idx] - tpp[pj]) * invdphi);
  }
  vaz_out[idx] = va;

  // SubStep3: Q+, Q-, radiative factor, energy update, clamp
  T e = e1[idx];
  T qp = T(0), qm = T(0);
  if (P.adiabatic) {
    if (interior) {
      T nu, h;
      nu_h(cols, i, e, sig, P, nu, h);
      if (P.heating) {
        const size_t up = idx + naz;
        const size_t upn = (size_t)(i + 1) * naz + jn;
        const T trp4 = T(0.25) * (trp[idx] + trp[up] + trp[(size_t)i * naz + jn] + trp[upn]);
        const T nu_sig = nu * sig;
        const T safe = nu_sig != T(0) ? T(2) * nu_sig : T(1);
        const T a = trr[idx], b = tpp[idx], d = divv[idx];
        qp = T(1) / safe * (a * a + T(2) * (trp4 * trp4) + b * b);
        qp = qp + T(2.0 / 9.0) * nu_sig * (d * d);
        qp = nu != T(0) ? qp * T(P.heat_factor) : T(0);
      }
      if (P.beta_on) qm = e * col(cols, i, C_OMEGA_K) * scal[1];
      const T x = T(P.mu * (P.gamma - 1.0)) / (T(P.R) * sig);
      const T x2 = x * x;
      const T inv_pow4 = x2 * x2;
      const T alpha = T(1) + T(2) * h * T(4) * T(P.sigma_sb) / T(P.c_light) *
                                 inv_pow4 * (e * e * e);
      qp = qp / alpha;
      qm = qm / alpha;
      T e_new = e + dt * (qp - qm);
      if (sig < T(P.sig_nf)) {        // heating/cooling equilibrium, tau_eff = 0
        e_new = T(0);
        qm = qp;
      }
      e = e_new;
    } else {
      qp = T(0);
      qm = T(0);
    }
    clamp_energy(e, sig, P);
    qp_out[idx] = qp;
    qm_out[idx] = qm;
  } else {
    qp_out[idx] = T(0);
    qm_out[idx] = T(0);
  }
  energy_out[idx] = e;
}

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  VkParams P{fp[0], fp[1], fp[2],  fp[3],  fp[4],  fp[5],  fp[6], fp[7],
             fp[8], fp[9], fp[10], fp[11], fp[12], fp[13],
             ip[2], ip[3], ip[4],  ip[5],  ip[6],  ip[7]};
  const int nr = ip[0], naz = ip[1];
  const T* sigma = (const T*)p[0];
  const T* vrad = (const T*)p[1];
  const T* vaz = (const T*)p[2];
  const T* energy = (const T*)p[3];
  const T* cols = (const T*)p[4];
  const T* scal = (const T*)p[5];
  T* vrad_out = (T*)p[6];
  T* vaz_out = (T*)p[7];
  T* energy_out = (T*)p[8];
  T* qp = (T*)p[9];
  T* qm = (T*)p[10];
  T* e1 = (T*)p[11];     // scratch (NR, NAZ)
  T* vr1 = (T*)p[12];    // scratch (NR+1, NAZ)
  T* va1 = (T*)p[13];    // scratch (NR, NAZ)
  T* trr = (T*)p[14];    // scratch (NR, NAZ) x 4
  T* tpp = (T*)p[15];
  T* trp = (T*)p[16];
  T* divv = (T*)p[17];
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n_face = (size_t)(nr + 1) * naz, n_cell = (size_t)nr * naz;
  vk_artvisc_kernel<T><<<n_blocks(n_face), BLOCK, 0, s>>>(
      sigma, vrad, vaz, energy, cols, scal, P, nr, naz, e1, vr1, va1);
  vk_stress_kernel<T><<<n_blocks(n_cell), BLOCK, 0, s>>>(
      sigma, e1, vr1, va1, cols, P, nr, naz, trr, tpp, trp, divv);
  vk_update_kernel<T><<<n_blocks(n_face), BLOCK, 0, s>>>(
      sigma, e1, vr1, va1, trr, tpp, trp, divv, cols, scal, P, nr, naz,
      vrad_out, vaz_out, energy_out, qp, qm);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

extern "C" {
int fc_viscous_kick_f32(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_viscous_kick_f64(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
