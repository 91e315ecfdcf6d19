// CFL time step on the GPU.
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `cfl_pallas` / `_cfl_kernel` (reference src/cfl.cpp:185-382). Computes
// the whole CFL dt of fargocpt_torch/ops/cfl.py `condition_cfl`: the
// per-cell sum of squared inverse-dt terms (sound speed, radial and
// residual azimuthal motion, SN or tensor artificial viscosity, viscosity,
// heating/cooling), its max over rings 1..NR-2, and the FARGO shear limit
// between neighbouring rings.
//
// Bound: device memory. Each cell reads sigma, energy, vrad (2 faces),
// vaz (2 cells), Q+ and Q- once: about 8 values per cell, 32 B in f32,
// for ~60 flops. Design: three launches.
//   1. vmean: one block per ring sums vaz (the FARGO mean velocity).
//   2. cells: a grid-stride loop over the active cells; each block
//      reduces its max of the squared inverse dt to one partial.
//   3. final: one block reduces the partials, takes the shear limit over
//      the rings, and writes dt = min(shear, cfl / sqrt(max)).
// No value leaves the device; dt is a one-element device tensor.
#include "common.cuh"

namespace fc {
namespace {

struct CflParams {
  double gamma, alpha, const_nu, c2, lf, inv_hc_limit, cfl, dphi, invdphi;
  int adiabatic, sn, fast;
};

template <typename T>
__global__ void vmean_kernel(const T* __restrict__ vaz, T* __restrict__ vmean,
                             int naz) {
  const T* row = vaz + (size_t)blockIdx.x * naz;
  T s = T(0);
  for (int j = threadIdx.x; j < naz; j += blockDim.x) s += row[j];
  s = block_reduce(s, SumOp(), T(0));
  if (threadIdx.x == 0) vmean[blockIdx.x] = s / T(naz);
}

template <typename T>
__global__ void cfl_cells_kernel(const T* __restrict__ sigma,
                                 const T* __restrict__ energy,
                                 const T* __restrict__ vrad,
                                 const T* __restrict__ vaz,
                                 const T* __restrict__ qplus,
                                 const T* __restrict__ qminus,
                                 const T* __restrict__ vmean,
                                 const T* __restrict__ cols, CflParams P,
                                 int nr, int naz, T* __restrict__ partial) {
  const size_t n = (size_t)(nr - 2) * naz;
  const T gg1 = T(P.gamma * (P.gamma - 1.0));
  const T sqrt_g = T(sqrt(P.gamma));
  const T lf = T(P.lf);
  const T four_c2 = T(4.0 * P.c2);
  T m = T(0);
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int i = 1 + (int)(idx / naz);
    const int j = (int)(idx % naz);
    const size_t c = (size_t)i * naz + j;
    const T sig = sigma[c];
    const T va = vaz[c];
    const T van = vaz[(size_t)i * naz + jnext(j, naz)];
    const T vr0 = vrad[c];
    const T vr1 = vrad[c + naz];
    const T inv_cell = col(cols, i, C_INV_CELL);
    const T inv_dxrad = col(cols, i, C_INV_DXRAD);
    const T inv_dxaz = col(cols, i, C_INV_DXAZ);

    T cs, nu;
    if (P.adiabatic) {
      cs = sqrt(gg1 * energy[c] / sig);
      const T h = cs / sqrt_g / col(cols, i, C_OMEGA_K);
      nu = P.alpha > 0.0 ? T(P.alpha) * cs * h : T(P.const_nu);
    } else {
      cs = col(cols, i, C_CS_ISO);
      const T h = cs / col(cols, i, C_OMEGA_K);
      nu = P.alpha > 0.0 ? T(P.alpha) * cs * h : T(P.const_nu);
    }
    const T vres = P.fast ? va - vmean[i] : va;
    const T invdt1 = cs * inv_cell;
    const T invdt2 = vr0 * inv_dxrad;
    const T invdt3 = vres * inv_dxaz;
    const T dv_r = vr1 - vr0;
    const T dv_phi = van - va;
    T invdt4;
    if (P.sn) {
      invdt4 = four_c2 * fmax(fmax(-dv_r, T(0)) * inv_dxrad,
                              fmax(-dv_phi, T(0)) * inv_dxaz) * lf;
    } else {
      const T inv_rb = col(cols, i, C_INV_RB);
      const T eps_rr = dv_r * col(cols, i, C_INV_DIFF_RSUP);
      const T eps_pp = inv_rb * (dv_phi * T(P.invdphi) + T(0.5) * (vr1 + vr0));
      invdt4 = four_c2 * -fmin(eps_rr + eps_pp, T(0)) * lf;
    }
    const T invdt5 = T(4) * nu * (inv_cell * inv_cell) * lf;
    T invdt6 = T(0);
    if (P.adiabatic)
      invdt6 = T(P.inv_hc_limit) * fabs((qplus[c] - qminus[c]) / energy[c]) * lf;
    const T inv_sq = invdt1 * invdt1 + invdt2 * invdt2 + invdt3 * invdt3 +
                     invdt4 * invdt4 + invdt5 * invdt5 + invdt6 * invdt6;
    m = nan_max(m, inv_sq);
  }
  m = block_reduce(m, MaxOp(), T(0));
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

template <typename T>
__global__ void cfl_final_kernel(const T* __restrict__ partial, int n_partial,
                                 const T* __restrict__ vmean,
                                 const T* __restrict__ cols, CflParams P,
                                 int nr, T* __restrict__ out_dt) {
  T m = T(0);
  for (int k = threadIdx.x; k < n_partial; k += blockDim.x)
    m = nan_max(m, partial[k]);
  m = block_reduce(m, MaxOp(), T(0));
  // shear limit between rings i, i+1 for i = 0..NR-3
  const T big = T(INFINITY);
  const T cfl_dphi = T(P.cfl * P.dphi);
  T s = big;
  for (int i = threadIdx.x; i < nr - 2; i += blockDim.x) {
    const T om0 = vmean[i] * col(cols, i, C_INV_RB);
    const T om1 = vmean[i + 1] * col(cols, i + 1, C_INV_RB);
    s = nan_min(s, cfl_dphi / (fabs(om0 - om1) + T(1e-100)));
  }
  s = block_reduce(s, MinOp(), big);
  if (threadIdx.x == 0) out_dt[0] = nan_min(s, T(P.cfl) / sqrt(m));
}

constexpr int N_PARTIAL = 1024;

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  CflParams P{fp[0], fp[1], fp[2], fp[3], fp[4], fp[5], fp[6], fp[7], fp[8],
              ip[2], ip[3], ip[4]};
  const int nr = ip[0], naz = ip[1];
  const T* sigma = (const T*)p[0];
  const T* energy = (const T*)p[1];
  const T* vrad = (const T*)p[2];
  const T* vaz = (const T*)p[3];
  const T* qplus = (const T*)p[4];
  const T* qminus = (const T*)p[5];
  const T* cols = (const T*)p[6];
  T* vmean = (T*)p[7];     // scratch (NR)
  T* partial = (T*)p[8];   // scratch (N_PARTIAL)
  T* out = (T*)p[9];       // (1,)
  cudaStream_t s = (cudaStream_t)stream;
  vmean_kernel<T><<<nr, BLOCK, 0, s>>>(vaz, vmean, naz);
  const size_t n = (size_t)(nr - 2) * naz;
  unsigned int nb = n_blocks(n);
  if (nb > N_PARTIAL) nb = N_PARTIAL;
  cfl_cells_kernel<T><<<nb, BLOCK, 0, s>>>(sigma, energy, vrad, vaz, qplus,
                                           qminus, vmean, cols, P, nr, naz,
                                           partial);
  cfl_final_kernel<T><<<1, 1024, 0, s>>>(partial, (int)nb, vmean, cols, P, nr,
                                         out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

extern "C" {
int fc_cfl_f32(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_cfl_f64(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
int fc_cfl_n_partial() { return fc::N_PARTIAL; }
const char* fc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
}
