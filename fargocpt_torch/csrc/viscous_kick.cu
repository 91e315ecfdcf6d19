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
// Bound: device memory by the count (4 planes in, 5 out), instructions in
// practice: the chain is four stages of 3x3 stencils with some twenty
// IEEE divisions and two square roots a cell. Design: one launch. A block
// of 256 threads owns a tile of VK_TH x VK_TW output cells and keeps every
// intermediate in shared memory, each computed once (the tile's halo
// apart):
//   0. load   sigma, vrad, vaz, energy with a halo of 2 cells each way
//             (columns wrap, rows stop at the grid's ends) and the tile's
//             rows of the column table;
//   1. q      the artificial pressures (q_r, q_phi of SN; q_rr, q_pp of
//             TW) and each cell's dissipation terms, on the tile plus
//             rows -2..TH and columns -2..TW;
//   2. kick   compression heating, the artificial viscosity kicks, the
//             clamp -> e1, vr1, va1, then nu and H of the cell, on the
//             tile plus one cell each way;
//   3. stress tau_rr, tau_pp, div v on rows -1..TH-1, columns -1..TW-1
//             and tau_rp on rows 0..TH, columns 0..TW;
//   4. update the velocity update, Q+, Q-, the energy update, on the tile:
//             the only values written to device memory.
// A plane whose values are dead takes the next stage's (q -> tau_rr,
// tau_pp; vrad -> tau_rp; vaz -> div v; energy -> e1 in place; the
// dissipation terms wait in the planes of vr1 and va1, which the same
// thread overwrites). All index arithmetic is on the tile's constants; no
// thread divides by NAZ. Every value goes through the operations of the
// plain version in their order.
//
// Q+ at ring NR-1 would read tau_rp at row NR; both ghost rings of Q+/Q-
// are written as zero, as the reference's cleared grids are.
//
// dt (and 1/beta where the cooling ramp makes it a tensor) are read from
// the device.
#include "common.cuh"

namespace fc {
namespace {

// The op's static parameters in the field type, converted once on the
// host (a conversion in the kernel would be an instruction a use): the
// same roundings as casting in place.
template <typename T>
struct VkParams {
  T gm1g;           // gamma (gamma - 1)
  T sqrt_gamma, gm1, neg_gm1, alpha, const_nu, c2, heat_factor, rvf, tmin,
      tmax, mu, R, mu_gm1, sigma_sb, c_light, sig_nf, invdphi, beta_inv;
  int adiabatic, artvisc, dissipation, compress, heating, beta_on, beta_dev;
  int alpha_on;     // alpha > 0 as the float64 parameter says it
};

constexpr int VK_TH = 16;                 // tile rows
constexpr int VK_TW = 64;                 // tile columns
constexpr int VK_HALO = 2;
constexpr int VK_THREADS = 256;
constexpr int VK_MIN_BLOCKS_F32 = 3;      // blocks a multiprocessor, for the
constexpr int VK_MIN_BLOCKS_F64 = 1;      // compiler's register budget
constexpr int VK_PH = VK_TH + 2 * VK_HALO;
constexpr int VK_PW = VK_TW + 2 * VK_HALO;
constexpr int VK_PLANE = VK_PH * VK_PW;   // a plane with its halo
constexpr int VK_OWN = VK_TH * VK_TW;
constexpr int VK_FULL_PLANES = 9;
// values of T in shared memory: the planes, H of the own cells, the rows
// of the column table
constexpr int VK_SMEM_VALUES =
    VK_FULL_PLANES * VK_PLANE + VK_OWN + VK_PH * N_COLS;

// position of tile cell (a, b), a in [-2, TH+1], b in [-2, TW+1], in a plane
__device__ __forceinline__ int at(int a, int b) {
  return (a + VK_HALO) * VK_PW + b + VK_HALO;
}

template <typename T>
__device__ __forceinline__ void clamp_energy(T& e, T sig,
                                             const VkParams<T>& P) {
  // energy_floor_ceiling: E in [Tmin, Tmax] * Sigma / mu * R / (gamma - 1)
  const T fac = sig / P.mu * P.R / P.gm1;
  e = fmin(fmax(e, P.tmin * fac), P.tmax * fac);
}

// nu and H of one cell from its (post-artvisc) energy; `cc` is the cell's
// row of the column table
template <typename T>
__device__ __forceinline__ void nu_h(const T* __restrict__ cc, T e, T sig,
                                     const VkParams<T>& P, T& nu, T& h) {
  T cs;
  if (P.adiabatic) {
    cs = sqrt(P.gm1g * e / sig);
    h = cs / P.sqrt_gamma / cc[C_OMEGA_K];
  } else {
    cs = cc[C_CS_ISO];
    h = cs / cc[C_OMEGA_K];
  }
  nu = P.alpha_on ? P.alpha * cs * h : P.const_nu;
}

template <typename T, int MIN_BLOCKS>
__global__ void __launch_bounds__(VK_THREADS, MIN_BLOCKS)
vk_tile_kernel(const T* __restrict__ sigma, const T* __restrict__ vrad,
               const T* __restrict__ vaz, const T* __restrict__ energy,
               const T* __restrict__ cols, const T* __restrict__ dtp,
               const T* __restrict__ betap, VkParams<T> P, int nr, int naz,
               T* __restrict__ vrad_out, T* __restrict__ vaz_out,
               T* __restrict__ energy_out, T* __restrict__ qp_out,
               T* __restrict__ qm_out) {
  extern __shared__ __align__(16) unsigned char vk_smem[];
  T* const s_sig = reinterpret_cast<T*>(vk_smem);
  T* const s_vr = s_sig + VK_PLANE;     // vrad, then tau_rp
  T* const s_va = s_vr + VK_PLANE;      // vaz, then div v
  T* const s_en = s_va + VK_PLANE;      // energy, then e1
  T* const s_qa = s_en + VK_PLANE;      // q_r / q_rr, then tau_rr
  T* const s_qb = s_qa + VK_PLANE;      // q_phi / q_pp, then tau_pp
  T* const s_vr1 = s_qb + VK_PLANE;     // dissipation term 1, then vr1
  T* const s_va1 = s_vr1 + VK_PLANE;    // dissipation term 2, then va1
  T* const s_nu = s_va1 + VK_PLANE;
  T* const s_h = s_nu + VK_PLANE;       // own cells only
  T* const s_cols = s_h + VK_OWN;       // rows i0-2 .. i0+TH+1

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * VK_TH;
  const int j0 = blockIdx.x * VK_TW;

  if (i0 == nr) {                       // only the outermost face: untouched
    for (int b = tid; b < VK_TW && j0 + b < naz; b += VK_THREADS) {
      const size_t c = (size_t)nr * naz + j0 + b;
      vrad_out[c] = vrad[c];
    }
    return;
  }

  const T dt = dtp[0];
  const T invdphi = P.invdphi;
  const bool diss = P.adiabatic && P.dissipation;

  // --- 0. load ---------------------------------------------------------
  for (int idx = tid; idx < VK_PLANE; idx += VK_THREADS) {
    const int pa = idx / VK_PW;
    const int i = i0 + pa - VK_HALO;
    if (i < 0 || i > nr) continue;
    int j = j0 + (idx - pa * VK_PW) - VK_HALO;
    if ((unsigned)j >= (unsigned)naz) j = wrap(j, naz);
    const size_t c = (size_t)i * naz + j;
    s_vr[idx] = vrad[c];
    if (i < nr) {
      s_sig[idx] = sigma[c];
      s_va[idx] = vaz[c];
      s_en[idx] = energy[c];
    }
  }
  for (int idx = tid; idx < VK_PH * N_COLS; idx += VK_THREADS) {
    const int pa = idx / N_COLS;
    const int i = i0 + pa - VK_HALO;
    if (i >= 0 && i <= nr) s_cols[idx] = cols[i * N_COLS + (idx - pa * N_COLS)];
  }
  __syncthreads();

  // --- 1. artificial pressures and the dissipation terms -----------------
  if (P.artvisc != 0) {
    constexpr int RW = VK_TW + 3;
    for (int idx = tid; idx < (VK_TH + 3) * RW; idx += VK_THREADS) {
      const int u = idx / RW;
      const int a = u - 2, b = idx - u * RW - 2;
      const int i = i0 + a;
      if (i < 0 || i > nr - 1) continue;
      const int p = at(a, b);
      const T* cc = s_cols + (a + VK_HALO) * N_COLS;
      const T sig = s_sig[p];
      const T vr0 = s_vr[p], vr1 = s_vr[p + VK_PW];
      const T dva = s_va[p + 1] - s_va[p];
      if (P.artvisc == 1) {             // Stone-Norman
        const T c2 = P.c2;
        const T dv_r = vr1 - vr0;
        const T q_r = dv_r < T(0) ? c2 * sig * (dv_r * dv_r) : T(0);
        const T q_phi = dva < T(0) ? c2 * sig * (dva * dva) : T(0);
        s_qa[p] = q_r;
        s_qb[p] = q_phi;
        if (diss && i >= 1 && i <= nr - 2) {
          s_vr1[p] = dt * q_r * dv_r * cc[C_INV_DIFF_RSUP];
          s_va1[p] = dt * q_phi * dva * (cc[C_INV_RB] * invdphi);
        }
      } else {                          // tensor (TW)
        const T eps_rr = (vr1 - vr0) * cc[C_INV_DIFF_RSUP];
        const T eps_pp = cc[C_INV_RB] * (dva * invdphi + T(0.5) * (vr1 + vr0));
        const T div = fmin(eps_rr + eps_pp, T(0));
        const T lsq = cc[C_L_SQ];
        s_qa[p] = lsq * sig * (-div) * (eps_rr - div / T(3));
        s_qb[p] = lsq * sig * (-div) * (eps_pp - div / T(3));
        if (diss && i >= 2 && i <= nr - 2) {
          const T d = eps_rr - eps_pp;
          const T qplus = -lsq * div * sig / T(3) *
                          (eps_rr * eps_rr + eps_pp * eps_pp + d * d);
          s_vr1[p] = qplus * dt;
        }
      }
    }
    __syncthreads();
  }

  // --- 2. compression heating, artificial viscosity, clamp, nu and H -----
  {
    constexpr int RW = VK_TW + 2;
    for (int idx = tid; idx < (VK_TH + 2) * RW; idx += VK_THREADS) {
      const int u = idx / RW;
      const int a = u - 1, b = idx - u * RW - 1;
      const int i = i0 + a;
      if (i < 0 || i > nr) continue;
      const int p = at(a, b);
      if (i == nr) {                    // outermost face: untouched
        s_vr1[p] = s_vr[p];
        continue;
      }
      const T* cc = s_cols + (a + VK_HALO) * N_COLS;
      const T inv_rb = cc[C_INV_RB];
      const T sig = s_sig[p];
      T en = s_en[p];
      T vr = s_vr[p];
      T va = s_va[p];
      const bool interior = i >= 1 && i <= nr - 2;
      const bool face = i >= 2 && i <= nr - 2;

      if (P.adiabatic && P.compress && i <= nr - 2) {
        const T div = (s_vr[p + VK_PW] * cc[N_COLS + C_RA] - vr * cc[C_RA]) *
                          cc[C_INV_DIFF_RSUP_RB] +
                      (s_va[p + 1] - va) * invdphi * inv_rb;
        en = en * exp(P.neg_gm1 * dt * div);
      }

      if (P.artvisc == 1) {
        const T q_r = s_qa[p], q_phi = s_qb[p];
        const T invdxtheta = inv_rb * invdphi;
        if (diss && interior) en = en - s_vr1[p] - s_va1[p];
        if (face) {
          const T sig_lo = s_sig[p - VK_PW];
          vr = vr + -dt * T(2) / (sig + sig_lo) * (q_r - s_qa[p - VK_PW]) *
                        cc[C_INVDRM];
        }
        if (interior) {
          const T sig_p = s_sig[p - 1];
          va = va + -dt * T(2) / (sig + sig_p) * (q_phi - s_qb[p - 1]) *
                        invdxtheta;
        }
      } else if (P.artvisc == 2) {
        const T q_rr = s_qa[p], q_pp = s_qb[p];
        if (diss && face) en = en + s_vr1[p];
        if (interior) {
          const T sig_phi = T(0.5) * (sig + s_sig[p - 1]);
          va = va + T(2) * dt / (cc[C_SUM_RS_RI] * sig_phi) *
                        (q_pp - s_qb[p - 1]) * invdphi;
        }
        if (face) {
          const T rb = cc[C_RB], rb_lo = cc[C_RB - N_COLS];
          const T sig_r = T(0.5) * (sig + s_sig[p - VK_PW]);
          vr = vr + P.rvf * dt / sig_r * T(2) / (rb * rb - rb_lo * rb_lo) *
                        ((q_rr * rb - s_qa[p - VK_PW] * rb_lo) -
                         T(0.5) * (q_pp + s_qb[p - VK_PW]) * (rb - rb_lo));
        }
      }
      if (diss) clamp_energy(en, sig, P);
      s_en[p] = en;
      s_vr1[p] = vr;
      s_va1[p] = va;
      T nu, h;
      nu_h(cc, en, sig, P, nu, h);
      s_nu[p] = nu;
      if (a >= 0 && a < VK_TH && b >= 0 && b < VK_TW) s_h[a * VK_TW + b] = h;
    }
  }
  __syncthreads();

  // --- 3. the stress tensor ----------------------------------------------
  {
    constexpr int RW = VK_TW + 1;
    for (int idx = tid; idx < (VK_TH + 1) * RW; idx += VK_THREADS) {
      const int u = idx / RW;
      const int v = idx - u * RW;
      {                                 // tau_rr, tau_pp, div v at (u-1, v-1)
        const int a = u - 1, b = v - 1;
        const int i = i0 + a;
        if (i >= 0 && i <= nr - 1) {
          const int p = at(a, b);
          const T* cc = s_cols + (a + VK_HALO) * N_COLS;
          const T inv_rb = cc[C_INV_RB];
          const T sig = s_sig[p], nu = s_nu[p];
          const T vr0 = s_vr1[p], vrn = s_vr1[p + VK_PW];
          const T dva = s_va1[p + 1] - s_va1[p];
          const T div = (vrn * cc[N_COLS + C_RA] - vr0 * cc[C_RA]) *
                            cc[C_INV_DIFF_RSUP_RB] +
                        dva * invdphi * inv_rb;
          const T drr = (vrn - vr0) * cc[C_INV_DIFF_RSUP];
          const T third = div / T(3);
          s_qa[p] = T(2) * nu * sig * (drr - third);
          const T dpp = dva * invdphi * inv_rb + T(0.5) * (vrn + vr0) * inv_rb;
          s_qb[p] = T(2) * nu * sig * (dpp - third);
          s_va[p] = div;
        }
      }
      {                                 // tau_rp at (u, v)
        const int i = i0 + u;
        if (i >= 0 && i <= nr - 1) {
          const int p = at(u, v);
          if (i == 0) {
            s_vr[p] = T(0);
          } else {
            const T* cc = s_cols + (u + VK_HALO) * N_COLS;
            const int lo = p - VK_PW, pj = p - 1, lopj = p - VK_PW - 1;
            const T dvazirdr = (s_va1[p] * cc[C_INV_RB] -
                                s_va1[lo] * cc[C_INV_RB - N_COLS]) *
                               cc[C_INVDRM];
            const T dvrdphi = (s_vr1[p] - s_vr1[pj]) * invdphi;
            const T drp = cc[C_RA] * dvazirdr + dvrdphi * cc[C_INV_RA];
            const T nu4 =
                T(0.25) * (s_nu[p] + s_nu[lo] + s_nu[pj] + s_nu[lopj]);
            const T sig4 =
                T(0.25) * (s_sig[p] + s_sig[lo] + s_sig[pj] + s_sig[lopj]);
            s_vr[p] = nu4 * sig4 * drp;
          }
        }
      }
    }
  }
  __syncthreads();

  // --- 4. velocity update and SubStep3 on the own cells ------------------
  const T* const s_trr = s_qa;
  const T* const s_tpp = s_qb;
  const T* const s_trp = s_vr;
  const T* const s_div = s_va;
  for (int idx = tid; idx < VK_OWN; idx += VK_THREADS) {
    const int a = idx / VK_TW, b = idx - a * VK_TW;
    const int i = i0 + a, j = j0 + b;
    if (i > nr || j >= naz) continue;
    const int p = at(a, b);
    const size_t c = (size_t)i * naz + j;
    if (i == nr) {
      vrad_out[c] = s_vr1[p];
      continue;
    }
    const T* cc = s_cols + (a + VK_HALO) * N_COLS;
    const T sig = s_sig[p];
    const bool interior = i >= 1 && i <= nr - 2;

    // v_rad, faces 2..NR-2
    T vr = s_vr1[p];
    if (i >= 2 && i <= nr - 2) {
      const int lo = p - VK_PW;
      const T rb = cc[C_RB], rb_lo = cc[C_RB - N_COLS];
      const T sig_avg_r = T(0.5) * (sig + s_sig[lo]);
      vr = vr + dt / sig_avg_r * P.rvf * T(2) / (rb + rb_lo) *
                    ((rb * s_trr[p] - rb_lo * s_trr[lo]) * cc[C_INVDRM] +
                     (s_trp[p + 1] - s_trp[p]) * invdphi -
                     T(0.5) * (s_tpp[p] + s_tpp[lo]));
    }
    vrad_out[c] = vr;

    // v_az, rings 1..NR-2
    T va = s_va1[p];
    if (interior) {
      const T sig_avg_phi = T(0.5) * (sig + s_sig[p - 1]);
      const T ra = cc[C_RA], ra_n = cc[N_COLS + C_RA];
      const T trp_rsq = ra * ra * s_trp[p];
      const T trp_rsq_up = ra_n * ra_n * s_trp[p + VK_PW];
      va = va + dt * cc[C_INV_RB] / sig_avg_phi *
                    (cc[C_TWO_DIFF_RA_SQ] * (trp_rsq_up - trp_rsq) +
                     (s_tpp[p] - s_tpp[p - 1]) * invdphi);
    }
    vaz_out[c] = va;

    // SubStep3: Q+, Q-, radiative factor, energy update, clamp
    T e = s_en[p];
    T qp = T(0), qm = T(0);
    if (P.adiabatic) {
      if (interior) {
        const T nu = s_nu[p], h = s_h[idx];
        if (P.heating) {
          const T trp4 = T(0.25) * (s_trp[p] + s_trp[p + VK_PW] +
                                    s_trp[p + 1] + s_trp[p + VK_PW + 1]);
          const T nu_sig = nu * sig;
          const T safe = nu_sig != T(0) ? T(2) * nu_sig : T(1);
          const T t_rr = s_trr[p], t_pp = s_tpp[p], d = s_div[p];
          qp = T(1) / safe * (t_rr * t_rr + T(2) * (trp4 * trp4) + t_pp * t_pp);
          qp = qp + T(2.0 / 9.0) * nu_sig * (d * d);
          qp = nu != T(0) ? qp * P.heat_factor : T(0);
        }
        if (P.beta_on)
          qm = e * cc[C_OMEGA_K] * (P.beta_dev ? betap[0] : P.beta_inv);
        const T x = P.mu_gm1 / (P.R * sig);
        const T x2 = x * x;
        const T inv_pow4 = x2 * x2;
        const T alpha = T(1) + T(2) * h * T(4) * P.sigma_sb / P.c_light *
                                   inv_pow4 * (e * e * e);
        qp = qp / alpha;
        qm = qm / alpha;
        T e_new = e + dt * (qp - qm);
        if (sig < P.sig_nf) {        // heating/cooling equilibrium, tau_eff = 0
          e_new = T(0);
          qm = qp;
        }
        e = e_new;
      }
      clamp_energy(e, sig, P);
    }
    qp_out[c] = qp;
    qm_out[c] = qm;
    energy_out[c] = e;
  }
}

template <typename T, int MIN_BLOCKS>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  // fp: gamma, alpha, constant nu, (C l)^2 of SN, heating factor, radial
  // viscosity factor, Tmin, Tmax, mu, R, sigma_SB, c, near-floor sigma,
  // 1 / dphi, 1 / beta
  const double gamma = fp[0];
  VkParams<T> P{T(gamma * (gamma - 1.0)), T(sqrt(gamma)), T(gamma - 1.0),
                T(-(gamma - 1.0)), T(fp[1]), T(fp[2]), T(fp[3]), T(fp[4]),
                T(fp[5]), T(fp[6]), T(fp[7]), T(fp[8]), T(fp[9]),
                T(fp[8] * (gamma - 1.0)), T(fp[10]), T(fp[11]), T(fp[12]),
                T(fp[13]), T(fp[14]),
                ip[2], ip[3], ip[4], ip[5], ip[6], ip[7], ip[8],
                fp[1] > 0.0};
  const int nr = ip[0], naz = ip[1];
  auto kernel = vk_tile_kernel<T, MIN_BLOCKS>;
  constexpr int smem = VK_SMEM_VALUES * (int)sizeof(T);
  // more than the 48 KB a block gets unasked: ask once per device
  static bool asked[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !asked[dev]) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    if (dev >= 0 && dev < 64) asked[dev] = true;
  }
  const dim3 grid((naz + VK_TW - 1) / VK_TW, (nr + 1 + VK_TH - 1) / VK_TH);
  kernel<<<grid, VK_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], P, nr, naz, (T*)p[7],
      (T*)p[8], (T*)p[9], (T*)p[10], (T*)p[11]);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

extern "C" {
int fc_viscous_kick_f32(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<float, fc::VK_MIN_BLOCKS_F32>(p, fp, ip, s);
}
int fc_viscous_kick_f64(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<double, fc::VK_MIN_BLOCKS_F64>(p, fp, ip, s);
}
}
