// The cold float64 PVTE refresh: (gamma_eff, mu, gamma1) of every cell.
//
// Replaces no Pallas kernel: the JAX package leaves the refresh to XLA
// (fargocpt_tpu/ops/pvte.py PVTE.gamma_mu, float64 branch). Its plain
// version is fargocpt_torch/ops/pvte.py: the cgs density and specific
// energy of the cell (PVTE.cgs), 48 halvings of log10 T on [0, 7]
// (temperature_from_energy), each deciding by the sign of the residual
// mu e (gamma_eff - 1) / R - T of _gamma_mu_at (the Saha fractions in the
// conjugate-root form with the 1e8 saturation, mu, eps with the
// 32-segment degree-10 funcdum fit by Horner), gamma_eff and mu at the
// midpoint T, and gamma1 by gamma1_at's finite differences (1e-4 in T and
// in rho). As PyTorch ops that is ~6,000 launches a refresh, each reading
// and writing whole planes in device memory.
//
// What bounds it: float64 instructions. Three planes in and three out are
// 48 B a cell; the refresh evaluates the equation of state 51 times a cell
// (48 halvings, then T(1 -/+ 1e-4) and T) with a pow, two exp, a log, two
// square roots and a handful of divisions each, so it runs on the FP64
// pipes. Design: one thread a cell, a grid-stride loop over the cells
// (any shape; the wrapper passes contiguous planes), every intermediate in
// registers. The 32 x 11 coefficient table is staged into shared memory
// once a block: neighbouring cells take different segments, which
// __constant__ memory would serialise. T^1.5 and k_B T are computed once
// an evaluation and serve both Saha fractions and eps; gamma1's central
// evaluation is the one that gives gamma_eff and mu, and its density
// derivatives reuse the central T's Saha numerators.
//
// The arithmetic follows the plain version on the card operation by
// operation (the library is built with --fmad=false and without fast
// math): where PyTorch divides by a Python float it multiplies by the
// float's reciprocal, and "c / t" is reciprocal(t) * c, so the kernel does
// the same, with the constants folded on the host as Python folds them.
//
// fp: the fields of PvteArgs in order (kernels.pvte_constants)
// ip: [0] number of cells, [1] 1, [2] shock tube (Sigma is the density)
// ptrs: sigma, energy, scale height (unread for a shock tube), funcdum
//       coefficients (32, 11), gamma_eff, mu, gamma1
#include "common.cuh"

namespace fc {
namespace {

constexpr int FD_SEGMENTS = 32;
constexpr int FD_COEFFS = 11;           // degree 10
constexpr int N_HALVINGS = 48;
constexpr int PVTE_BLOCK = 128;
constexpr int PVTE_MIN_BLOCKS = 4;     // at most 128 registers a thread

struct PvteArgs {
  double x_mf, cx, cy, ex, ey, kb, two_xmf, c_hi, eps_he, c_hh, two_kb,
      c_hii, c_h2, fd_lo, fd_hi, fd_w, fd_inv_w, inv_r, lo_fac, hi_fac,
      density_factor, to_density, to_e_spec;
};
constexpr int N_FP = sizeof(PvteArgs) / sizeof(double);

// the Saha numerators cx T^1.5 exp(-chi_x / k_B T) (and of y) and k_B T:
// the part of the fractions that does not depend on the density
struct Saha {
  double nx, ny, kt;
};

__device__ __forceinline__ Saha saha(double T, const PvteArgs& a) {
  const double t15 = pow(T, 1.5);
  const double kt = T * a.kb;
  const double rkt = 1.0 / kt;
  return {t15 * a.cx * exp(rkt * a.ex), t15 * a.cy * exp(rkt * a.ey), kt};
}

// 2 / (1 + sqrt(1 + 4 / A)) with A = numerator / rho, 1 from A = 1e8 on
__device__ __forceinline__ double saha_fraction(double num, double rho) {
  const double A = num / rho;
  const double f = (1.0 / (sqrt((1.0 / A) * 4.0 + 1.0) + 1.0)) * 2.0;
  return A < 1e8 ? f : 1.0;
}

__device__ __forceinline__ double mean_mu(double x, double y,
                                          const PvteArgs& a) {
  const double d = (((y + 1.0) + ((y * 2.0) * x)) * a.two_xmf + 1.0) - a.x_mf;
  return (1.0 / d) * 4.0;
}

// funcdum(ln T) from the segment fit: the clamped ln T's segment, then
// Horner in x on [-1, 1]; a NaN stays NaN, as torch.clamp keeps it
__device__ __forceinline__ double funcdum(double ln_t, const double* coef,
                                          const PvteArgs& a) {
  const double y = isnan(ln_t) ? ln_t : fmin(fmax(ln_t, a.fd_lo), a.fd_hi);
  const int s = clampi((int)((y - a.fd_lo) * a.fd_inv_w), 0, FD_SEGMENTS - 1);
  const double x = (((y - a.fd_lo) - (double)s * a.fd_w) * 2.0) * a.fd_inv_w
                   - 1.0;
  const double* c = coef + s * FD_COEFFS;
  double out = c[FD_COEFFS - 1];
#pragma unroll
  for (int d = FD_COEFFS - 2; d >= 0; --d) out = out * x + c[d];
  return out;
}

struct State {
  double mu, eps, gamma;
};

// _gamma_mu_at(rho, T) given T's Saha numerators
__device__ __forceinline__ State evaluate(double rho, double T, const Saha& s,
                                          const double* coef,
                                          const PvteArgs& a) {
  const double x = saha_fraction(s.nx, rho);
  const double y = saha_fraction(s.ny, rho);
  const double mu = mean_mu(x, y, a);
  const double eps_h2 = ((1.0 - y) * a.c_h2) * funcdum(log(T), coef, a);
  const double eps_hii = ((x * a.c_hii) * y) / s.kt;
  const double eps_hh = (y * a.c_hh) / (T * a.two_kb);
  const double eps_hi = ((x + 1.0) * a.c_hi) * y;
  const double eps = (((eps_h2 + eps_hii) + eps_hh) + a.eps_he) + eps_hi;
  return {mu, eps, 1.0 / (mu * eps) + 1.0};
}

// A template, like every kernel of the library, so that the profiler names
// it "void fc::..." and never with the "fc:" prefix of the spans' ranges.
template <int HALVINGS>
__global__ void __launch_bounds__(PVTE_BLOCK, PVTE_MIN_BLOCKS)
pvte_refresh_kernel(const double* __restrict__ sigma,
                    const double* __restrict__ energy,
                    const double* __restrict__ scale_height,
                    const double* __restrict__ coeffs, const PvteArgs a,
                    int n, int shock_tube, double* __restrict__ gamma_out,
                    double* __restrict__ mu_out,
                    double* __restrict__ gamma1_out) {
  __shared__ double coef[FD_SEGMENTS * FD_COEFFS];
  for (int k = threadIdx.x; k < FD_SEGMENTS * FD_COEFFS; k += blockDim.x)
    coef[k] = coeffs[k];
  __syncthreads();

  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x) {
    const double sig = sigma[idx];
    const double rho = shock_tube
        ? sig * a.to_density
        : (sig / (scale_height[idx] * a.density_factor)) * a.to_density;
    const double e = (energy[idx] / sig) * a.to_e_spec;

    // 48 halvings of log10 T on [0, 7]: keep the half where the residual
    // mu e (gamma_eff - 1) / R - T changes sign
    double lo = 0.0, hi = 7.0;
#pragma unroll 1
    for (int it = 0; it < HALVINGS; ++it) {
      const double mid = (lo + hi) * 0.5;
      const double T = pow(10.0, mid);
      const State st = evaluate(rho, T, saha(T, a), coef, a);
      const double resid = (((st.mu * e) * (st.gamma - 1.0)) * a.inv_r) - T;
      if (resid < 0.0) {
        hi = mid;
      } else {
        lo = mid;
      }
    }
    const double T = pow(10.0, (lo + hi) * 0.5);

    // gamma1 by finite differences in T and in rho
    const double tl = T * a.lo_fac, tr = T * a.hi_fac;
    const double dt = tl - tr;
    const State sl = evaluate(rho, tl, saha(tl, a), coef, a);
    const State sr = evaluate(rho, tr, saha(tr, a), coef, a);
    const Saha sc = saha(T, a);
    const State c = evaluate(rho, T, sc, coef, a);
    const double cv = ((sl.eps * tl) - (sr.eps * tr)) / dt;
    const double p = ((c.gamma - 1.0) * c.eps) * T;
    const double chi_t = 1.0 - (((T / c.mu) * (sl.mu - sr.mu)) / dt);
    const double rl = rho * a.lo_fac, rr = rho * a.hi_fac;
    const double drho = rl - rr;
    const double mu_rl = mean_mu(saha_fraction(sc.nx, rl),
                                 saha_fraction(sc.ny, rl), a);
    const double mu_rr = mean_mu(saha_fraction(sc.nx, rr),
                                 saha_fraction(sc.ny, rr), a);
    const double chi_rho = 1.0 - (((rho / c.mu) * (mu_rl - mu_rr)) / drho);

    gamma_out[idx] = c.gamma;
    mu_out[idx] = c.mu;
    gamma1_out[idx] = ((p * (chi_t * chi_t)) / (cv * T)) + chi_rho;
  }
}

int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  const int n = ip[0];
  PvteArgs a;
  double* fields = reinterpret_cast<double*>(&a);
  for (int k = 0; k < N_FP; ++k) fields[k] = fp[k];
  // enough blocks to fill every multiprocessor, each then striding
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pvte_refresh_kernel<N_HALVINGS>, PVTE_BLOCK, 0);
    max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int needed = (int)(((size_t)n + PVTE_BLOCK - 1) / PVTE_BLOCK);
  const int blocks = needed < max_blocks ? needed : max_blocks;
  pvte_refresh_kernel<N_HALVINGS>
      <<<blocks, PVTE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const double*)p[0], (const double*)p[1], (const double*)p[2],
      (const double*)p[3], a, n, ip[2], (double*)p[4], (double*)p[5],
      (double*)p[6]);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

extern "C" {
int fc_pvte_refresh_f64(void* const* p, const double* fp, const int* ip,
                        void* s) {
  return fc::launch(p, fp, ip, s);
}
}
