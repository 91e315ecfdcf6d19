// Potential + momentum source terms on the GPU.
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `sources_fused_pallas` / `_sources_kernel` (reference
// src/SourceEuler.cpp:325-428 and src/Pframeforce.cpp:21-95): the N-body
// potential with epsilon-H smoothing and Klahr cubic smoothing, the radial
// kick (pressure and potential gradients plus centrifugal) on faces
// 2..NR-2 and the azimuthal kick (plus the imposed drift) on rings
// 1..NR-2. Compression heating is left to the viscous kick.
//
// Bound: device memory. A thread reads sigma, energy, vaz, vrad of its
// cell and the neighbours (i-1, j), (i, j-1), (i, j+1), mostly from L1/L2,
// and writes vrad and vaz once: about 6 values per cell moved from device
// memory, 24 B in f32. The potential grid is never stored: each thread
// re-evaluates it at its three stencil points from the per-body scalars
// (~25 flops per body and point), which costs less than a round trip of a
// potential grid through device memory. One launch over (NR+1) x NAZ.
//
// Per-body scalars live on the device (`scal`), so dt, the frame rate and
// the indirect term never travel to the host:
//   scal = [dt, omega_frame, indirect_x, indirect_y,
//           (mass, x, y, r_cubic, eps_h_scalar, smoothing_mode) per body]
// smoothing_mode: 0 none, 1 the scalar eps*h at the planet, 2 eps*H(cell).
#include "common.cuh"

namespace fc {
namespace {

struct SrcParams {
  double gamma, eps, G;
  int adiabatic, n_bodies, has_drift;
};

constexpr int SCAL_HEAD = 4;
constexpr int SCAL_PER_BODY = 6;

template <typename T>
struct Cell {
  T sig, press, pot;
};

template <typename T>
__device__ __forceinline__ Cell<T> eval_cell(const T* __restrict__ sigma,
                                             const T* __restrict__ energy,
                                             const T* __restrict__ cols,
                                             const T* __restrict__ cosp,
                                             const T* __restrict__ sinp,
                                             const T* __restrict__ scal,
                                             const SrcParams& P, int i, int j,
                                             int naz) {
  const size_t c = (size_t)i * naz + j;
  Cell<T> out;
  out.sig = sigma[c];
  T h;
  if (P.adiabatic) {
    const T e = energy[c];
    out.press = T(P.gamma - 1.0) * e;
    const T cs = sqrt(T(P.gamma * (P.gamma - 1.0)) * e / out.sig);
    h = cs / T(sqrt(P.gamma)) / col(cols, i, C_OMEGA_K);
  } else {
    const T cs = col(cols, i, C_CS_ISO);
    out.press = out.sig * (cs * cs);
    h = cs / col(cols, i, C_OMEGA_K);
  }
  const T rb = col(cols, i, C_RB);
  const T x = rb * cosp[j];
  const T y = rb * sinp[j];
  T pot = T(0);
  for (int k = 0; k < P.n_bodies; ++k) {
    const T* b = scal + SCAL_HEAD + SCAL_PER_BODY * k;
    const T mode = b[5];
    T sm = T(0);
    if (mode == T(2)) sm = T(P.eps) * h;
    else if (mode == T(1)) sm = b[4];
    const T dx = x - b[1];
    const T dy = y - b[2];
    const T d = sqrt(dx * dx + dy * dy + sm * sm);
    const T rsm = b[3];
    T klahr = T(1);
    if (rsm > T(0) && d < rsm) {
      const T q = d / rsm;
      klahr = q * q * q * q - T(2) * (q * q * q) + T(2) * q;
    }
    pot = pot - T(P.G) * b[0] / d * klahr;
  }
  out.pot = pot - scal[2] * x - scal[3] * y;
  return out;
}

template <typename T>
__global__ void sources_kernel(const T* __restrict__ sigma,
                               const T* __restrict__ energy,
                               const T* __restrict__ vaz,
                               const T* __restrict__ vrad,
                               const T* __restrict__ cols,
                               const T* __restrict__ cosp,
                               const T* __restrict__ sinp,
                               const T* __restrict__ scal, SrcParams P, int nr,
                               int naz, T* __restrict__ vrad_out,
                               T* __restrict__ vaz_out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)(nr + 1) * naz) return;
  const int i = (int)(idx / naz);
  const int j = (int)(idx % naz);
  const T dt = scal[0];
  const T omega = scal[1];
  const bool face = i >= 2 && i <= nr - 2;
  const bool ring = i >= 1 && i <= nr - 2;
  if (!face && !ring) {
    vrad_out[idx] = vrad[idx];
    if (i < nr) vaz_out[idx] = vaz[idx];
    return;
  }
  const Cell<T> here = eval_cell(sigma, energy, cols, cosp, sinp, scal, P, i, j, naz);
  const int jn = jnext(j, naz);

  // radial momentum, face i between rings i-1 and i (SourceEuler.cpp:325-372)
  if (face) {
    const Cell<T> lo = eval_cell(sigma, energy, cols, cosp, sinp, scal, P, i - 1, j, naz);
    const T invdrm = col(cols, i, C_INVDRM);
    const T gradp = T(2) / (here.sig + lo.sig) * (here.press - lo.press) * invdrm;
    const T gradphi = (here.pot - lo.pot) * invdrm;
    const size_t r0 = (size_t)i * naz, r1 = (size_t)(i - 1) * naz;
    const T vsum = vaz[r0 + j] + vaz[r0 + jn] + vaz[r1 + j] + vaz[r1 + jn];
    const T vt = T(0.25) * vsum + col(cols, i, C_RA) * omega;
    const T cen = vt * vt * col(cols, i, C_INV_RA);
    vrad_out[idx] = vrad[idx] + dt * (-gradp - gradphi + cen);
  } else {
    vrad_out[idx] = vrad[idx];
  }

  // azimuthal momentum, ring i between cells j-1 and j (:375-428)
  if (ring) {
    const Cell<T> prev =
        eval_cell(sigma, energy, cols, cosp, sinp, scal, P, i, jprev(j, naz), naz);
    const T invdxth = col(cols, i, C_SRC_INVDXTHETA);
    const T gradp = T(2) / (here.sig + prev.sig) * (here.press - prev.press) * invdxth;
    const T gradphi = (here.pot - prev.pot) * invdxth;
    T v = vaz[idx] + dt * (-gradp - gradphi);
    if (P.has_drift) v = v + dt * col(cols, i, C_DRIFT);
    vaz_out[idx] = v;
  } else if (i < nr) {
    vaz_out[idx] = vaz[idx];
  }
}

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  SrcParams P{fp[0], fp[1], fp[2], ip[2], ip[3], ip[4]};
  const int nr = ip[0], naz = ip[1];
  const size_t n = (size_t)(nr + 1) * naz;
  sources_kernel<T><<<n_blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7], P, nr,
      naz, (T*)p[8], (T*)p[9]);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

extern "C" {
int fc_sources_f32(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_sources_f64(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
