// Device code shared by the FARGO transport kernels with one thread per
// cell: the two of the split route (radial_momenta_sweep.cu,
// fargo_theta.cu) and the two sweeps of the staged route (radial_sweep.cu,
// theta_sweep.cu). The whole-transport kernel (transport.cu) tiles the same
// arithmetic its own way.
//
// The advected batch is (K, NR, NAZ), ordered [rp, rm, ap, am, (energy),
// sigma]: K = 6 adiabatic, 5 isothermal; entry K-1 is the density.
#pragma once

#include "common.cuh"

namespace fc {

// specific value (quantity / sigma) of quantity k at cell (r, j), and the
// quantity itself, from the transport's input fields (reference
// src/TransportEuler.cpp:471-493 compute_momenta_from_velocities)
template <typename T>
__device__ __forceinline__ void quantity(const T* __restrict__ sigma,
                                         const T* __restrict__ vrad,
                                         const T* __restrict__ vaz,
                                         const T* __restrict__ energy,
                                         const T* __restrict__ cols, T omega,
                                         int k, int k_sigma, int r, int j,
                                         int naz, T& q, T& work) {
  const size_t c = (size_t)r * naz + j;
  const T sig = sigma[c];
  if (k == k_sigma) {
    q = sig;
  } else if (k == 0) {
    q = sig * vrad[c + naz];
  } else if (k == 1) {
    q = sig * vrad[c];
  } else if (k == 2 || k == 3) {
    const T rb = col(cols, r, C_RB);
    const T corot = rb * omega;
    const T v = k == 2 ? vaz[(size_t)r * naz + jnext(j, naz)] : vaz[c];
    q = sig * (v + corot) * rb;
  } else {
    q = energy[c];
  }
  work = q / sig;
}

// upwind face value at face f of the radial profile w[0..3] = rows f-2..f+1
// (van Leer / MC slope; faces 0 and NR carry nothing)
template <typename T>
__device__ __forceinline__ T star_radial(const T* w, int f, int nr, T vr, T dt,
                                         const T* __restrict__ cols, int kind) {
  if (f < 1 || f > nr - 1) return T(0);
  // slopes at rows f-1 (w[1]) and f (w[2]); zero outside rows 1..NR-2
  T dq_lo = T(0), dq_hi = T(0);
  if (f - 1 >= 1) {
    const T dqm = (w[1] - w[0]) * col(cols, f - 1, C_INVDRM);
    const T dqp = (w[2] - w[1]) * col(cols, f, C_INVDRM);
    dq_lo = limiter(dqp, dqm, kind);
  }
  if (f <= nr - 2) {
    const T dqm = (w[2] - w[1]) * col(cols, f, C_INVDRM);
    const T dqp = (w[3] - w[2]) * col(cols, f + 1, C_INVDRM);
    dq_hi = limiter(dqp, dqm, kind);
  }
  if (vr > T(0)) return w[1] + (col(cols, f, C_CM) - vr * dt) * T(0.5) * dq_lo;
  return w[2] - (col(cols, f, C_CP) + vr * dt) * T(0.5) * dq_hi;
}

// the specific values of quantity k in rows i-2..i+2 (clamped to the grid)
// of column j, and the quantity at row i
template <typename T>
__device__ __forceinline__ void radial_profile(const T* __restrict__ sigma,
                                               const T* __restrict__ vrad,
                                               const T* __restrict__ vaz,
                                               const T* __restrict__ energy,
                                               const T* __restrict__ cols,
                                               T omega, int k, int k_sigma,
                                               int i, int j, int nr, int naz,
                                               T* w, T& q) {
  for (int d = 0; d < 5; ++d) {
    T qd, wd;
    quantity(sigma, vrad, vaz, energy, cols, omega, k, k_sigma,
             clampi(i - 2 + d, 0, nr - 1), j, naz, qd, wd);
    w[d] = wd;
    if (d == 2) q = qd;
  }
}

// azimuthal upwind value at interface c (between cells c-1 and c) of the
// ring profile w[0..3] = cells c-2..c+1, for the displacement ksi
template <typename T>
__device__ __forceinline__ T star_theta(const T* w, T ksi, T dxtheta, int kind) {
  const T dq_lo = T(0.5) * limiter(w[2] - w[1], w[1] - w[0], kind) / dxtheta;
  const T dq_hi = T(0.5) * limiter(w[3] - w[2], w[2] - w[1], kind) / dxtheta;
  if (ksi > T(0)) return w[1] + (dxtheta - ksi) * dq_lo;
  return w[2] - (dxtheta + ksi) * dq_hi;
}

// One azimuthal van Leer sweep of the batch `qin` (K, NR, NAZ) at cell c of
// ring i, whose ring neighbours are jj[0..4] = cells c-2..c+2 (reference
// src/TransportEuler.cpp:630-664 VanLeerTheta). v0 and v1 are the sweep
// velocities at the cell's interfaces c and c+1. Every quantity divides
// by the same pre-sweep density. Writes the K swept values to
// qout[k * NR * NAZ + out_idx].
template <typename T>
__device__ __forceinline__ void theta_sweep_cell(
    const T* __restrict__ qin, const T* __restrict__ cols, int K, int nr,
    int naz, int i, const int* jj, T v0, T v1, T dt, T dphi, int kind,
    T* __restrict__ qout, size_t out_idx) {
  const size_t plane = (size_t)nr * naz;
  const size_t row = (size_t)i * naz;
  const T dxtheta = dphi * col(cols, i, C_RB);
  const T coef = col(cols, i, C_COEF) * dt;
  const T inv_surf = col(cols, i, C_INV_SURF);
  const T ksi0 = v0 * dt, ksi1 = v1 * dt;

  const T* sig_in = qin + (size_t)(K - 1) * plane + row;
  T s[5];
  for (int d = 0; d < 5; ++d) s[d] = sig_in[jj[d]];
  const T ds0 = star_theta(s, ksi0, dxtheta, kind);
  const T ds1 = star_theta(s + 1, ksi1, dxtheta, kind);

  for (int k = 0; k < K; ++k) {
    const T* qk = qin + (size_t)k * plane + row;
    T w[5];
    for (int d = 0; d < 5; ++d) w[d] = qk[jj[d]] / s[d];
    const T st0 = star_theta(w, ksi0, dxtheta, kind);
    const T st1 = star_theta(w + 1, ksi1, dxtheta, kind);
    const T f0 = coef * st0 * ds0 * v0;
    const T f1 = coef * st1 * ds1 * v1;
    qout[(size_t)k * plane + out_idx] = qk[jj[2]] + (f0 - f1) * inv_surf;
  }
}

// One azimuthal sweep of the batch as a kernel, one thread per cell (i, j)
// sweeping all K quantities: the launches of fargo_theta.cu (with the
// uniform velocity and the roll as flags) and of theta_sweep.cu (neither).
// With `roll` the thread computes the swept value of the source cell
// (j - s_i) mod NAZ and writes it at j; with `uniform` both interfaces
// move with vconst[i]. vconst and nshift are read only under their flag.
namespace {

template <typename T>
__global__ void theta_sweep_kernel(const T* __restrict__ qin,
                                   const T* __restrict__ vres,
                                   const T* __restrict__ vconst,
                                   const int* __restrict__ nshift,
                                   const T* __restrict__ cols,
                                   const T* __restrict__ scal, double dphi,
                                   int nr, int naz, int K, int kind,
                                   int uniform, int roll,
                                   T* __restrict__ qout) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)nr * naz) return;
  const int i = (int)(idx / naz);
  const int j = (int)(idx % naz);
  const int c = roll ? wrap(j - wrap(nshift[i], naz), naz) : j;
  int jj[5];                         // cells c-2 .. c+2
  for (int d = 0; d < 5; ++d) jj[d] = wrap(c - 2 + d, naz);
  const size_t row = (size_t)i * naz;
  const T v0 = uniform ? vconst[i] : vres[row + c];
  const T v1 = uniform ? vconst[i] : vres[row + jj[3]];
  theta_sweep_cell(qin, cols, K, nr, naz, i, jj, v0, v1, scal[0], T(dphi),
                   kind, qout, idx);
}

}  // namespace

}  // namespace fc
