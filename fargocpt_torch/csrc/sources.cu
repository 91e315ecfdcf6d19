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
// Bound: device memory by the count (4 planes in, 2 out: 24 B a cell in
// f32), instructions in practice: a cell's (sigma, pressure, potential)
// costs a square root and three IEEE divisions, and per body a square root
// and a division more. Design: one launch; a block of 256 threads owns a
// tile of SRC_TH x SRC_TW output cells.
//   1. eval  (sigma, pressure, potential) of every cell of the tile plus
//            one row below and one column before it (columns wrap), each
//            once, into shared memory. The potential grid never reaches
//            device memory.
//   2. kick  the radial and azimuthal kicks of the own cells from the
//            cell itself, the one below and the one before.
// Index arithmetic is on the tile's constants; no thread divides by NAZ.
// Every value goes through the operations of the plain version in their
// order.
//
// The per-body values are read from the N-body state's own float64 tensors
// (x, y, mass, cubic smoothing radius) and cast to the field type, as the
// plain version casts them; a block casts them once into shared memory,
// with the scalar smoothing length eps h(r_body) where the mode asks for it.
// dt (field type), the frame rate and the two indirect terms (each in the
// field type or in float64, as the caller holds it: `scalar_f64` says
// which) are read from the device too, so no value travels to the host and
// nothing is packed before the launch.
// smoothing mode: 0 none, 1 the scalar eps*h at the planet, 2 eps*H(cell);
// the first body's and the others' are static. With a smoothing plane
// `h_smooth` (NR x NAZ; a null pointer without) mode 2 takes eps times the
// plane's H of the cell in place of the H it derives from the current
// energy (the leapfrog's kicks smooth with a scale height of an earlier
// stage); the pressure still comes from the current fields.
//
// Any number of bodies: the per-body table streams through shared memory
// in chunks of MAX_CHUNK bodies. Each cell's potential waits in the
// shared plane between chunks, so its sum over the bodies runs in index
// order, as the plain version's does.
#include "common.cuh"

namespace fc {
namespace {

// The op's static parameters in the field type, converted once on the
// host (a conversion in the kernel would be an instruction a use): the
// same roundings as casting in place.
template <typename T>
struct SrcParams {
  T gm1, gm1g, sqrt_gamma, eps, G, aspect;
  double pow_body_r;  // 1 + flaring index
  int adiabatic, n_bodies, has_drift, mode_first, mode_rest;
  int scalar_f64;     // bit 0 the frame rate, 1 and 2 the indirect terms
};

constexpr int SRC_TH = 16;                // tile rows
constexpr int SRC_TW = 64;                // tile columns
constexpr int SRC_THREADS = 256;
constexpr int SRC_PW = SRC_TW + 1;        // a plane: the tile, a row below,
constexpr int SRC_PLANE = (SRC_TH + 1) * SRC_PW;  // a column before
constexpr int BODY_VALUES = 5;            // mass, x, y, r_cubic, eps h(r_body)
constexpr int MAX_CHUNK = 512;            // bodies in shared memory at once

// a device scalar held in float64 or in the field type, as T
template <typename T>
__device__ __forceinline__ T scalar_at(const void* p, bool is_f64) {
  return is_f64 ? T(*static_cast<const double*>(p))
                : *static_cast<const T*>(p);
}

// x ** e as PyTorch's scalar-exponent pow computes it
template <typename T>
__device__ __forceinline__ T pow_scalar(T x, double e) {
  if (e == 1.0) return x;
  if (e == 2.0) return x * x;
  if (e == 3.0) return x * x * x;
  if (e == 0.5) return sqrt(x);
  return pow(x, T(e));
}

template <typename T>
__global__ void __launch_bounds__(SRC_THREADS)
sources_kernel(const T* __restrict__ sigma, const T* __restrict__ energy,
               const T* __restrict__ vaz, const T* __restrict__ vrad,
               const T* __restrict__ cols, const T* __restrict__ cosp,
               const T* __restrict__ sinp, const T* __restrict__ dtp,
               const void* __restrict__ omegap,
               const void* __restrict__ ind_xp,
               const void* __restrict__ ind_yp,
               const double* __restrict__ body_x,
               const double* __restrict__ body_y,
               const double* __restrict__ body_mass,
               const double* __restrict__ body_rsm,
               const T* __restrict__ h_smooth, SrcParams<T> P, int nr,
               int naz, T* __restrict__ vrad_out, T* __restrict__ vaz_out) {
  extern __shared__ __align__(16) unsigned char src_smem[];
  T* const s_sig = reinterpret_cast<T*>(src_smem);
  T* const s_press = s_sig + SRC_PLANE;
  T* const s_pot = s_press + SRC_PLANE;
  T* const s_body = s_pot + SRC_PLANE;  // BODY_VALUES per body

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * SRC_TH;
  const int j0 = blockIdx.x * SRC_TW;

  const T ind_x = scalar_at<T>(ind_xp, P.scalar_f64 & 2);
  const T ind_y = scalar_at<T>(ind_yp, P.scalar_f64 & 4);
  for (int k0 = 0; k0 < P.n_bodies; k0 += MAX_CHUNK) {
    const int k1 = min(P.n_bodies, k0 + MAX_CHUNK);
    const bool last = k1 == P.n_bodies;
    if (k0 > 0) __syncthreads();        // the previous chunk has been read
    for (int k = k0 + tid; k < k1; k += SRC_THREADS) {
      T* b = s_body + BODY_VALUES * (k - k0);
      const T bx = T(body_x[k]), by = T(body_y[k]);
      b[0] = T(body_mass[k]);
      b[1] = bx;
      b[2] = by;
      b[3] = T(body_rsm[k]);
      T sm = T(0);
      if ((k == 0 ? P.mode_first : P.mode_rest) == 1) {
        const T body_r = sqrt(bx * bx + by * by);
        sm = P.eps * (P.aspect * pow_scalar(body_r, P.pow_body_r));
      }
      b[4] = sm;
    }
    __syncthreads();

    // --- 1. (sigma, pressure, potential) of rows -1..TH-1, columns -1..TW-1
    for (int idx = tid; idx < SRC_PLANE; idx += SRC_THREADS) {
      const int u = idx / SRC_PW;
      const int i = i0 + u - 1;
      if (i < 1 || i > nr - 2) continue;  // the ghost rings are never read
      int j = j0 + (idx - u * SRC_PW) - 1;
      if ((unsigned)j >= (unsigned)naz) j = wrap(j, naz);
      const size_t c = (size_t)i * naz + j;
      const T sig = sigma[c];
      T press, h;
      if (P.adiabatic) {
        const T e = energy[c];
        press = P.gm1 * e;
        const T cs = sqrt(P.gm1g * e / sig);
        h = cs / P.sqrt_gamma / col(cols, i, C_OMEGA_K);
      } else {
        const T cs = col(cols, i, C_CS_ISO);
        press = sig * (cs * cs);
        h = cs / col(cols, i, C_OMEGA_K);
      }
      if (h_smooth != nullptr) h = h_smooth[c];
      const T rb = col(cols, i, C_RB);
      const T x = rb * cosp[j];
      const T y = rb * sinp[j];
      T pot = k0 == 0 ? T(0) : s_pot[idx];
      for (int k = k0; k < k1; ++k) {
        const T* b = s_body + BODY_VALUES * (k - k0);
        const int mode = k == 0 ? P.mode_first : P.mode_rest;
        T sm = T(0);
        if (mode == 2) sm = P.eps * h;
        else if (mode == 1) sm = b[4];
        const T dx = x - b[1];
        const T dy = y - b[2];
        const T d = sqrt(dx * dx + dy * dy + sm * sm);
        const T rsm = b[3];
        T klahr = T(1);
        if (rsm > T(0) && d < rsm) {
          const T q = d / rsm;
          klahr = q * q * q * q - T(2) * (q * q * q) + T(2) * q;
        }
        pot = pot - P.G * b[0] / d * klahr;
      }
      if (last) {
        s_sig[idx] = sig;
        s_press[idx] = press;
        s_pot[idx] = pot - ind_x * x - ind_y * y;
      } else {
        s_pot[idx] = pot;
      }
    }
  }
  __syncthreads();

  // --- 2. the kicks of the own cells ----------------------------------------
  const T dt = dtp[0];
  const T omega = scalar_at<T>(omegap, P.scalar_f64 & 1);
  for (int idx = tid; idx < SRC_TH * SRC_TW; idx += SRC_THREADS) {
    const int a = idx / SRC_TW, b = idx - a * SRC_TW;
    const int i = i0 + a, j = j0 + b;
    if (i > nr || j >= naz) continue;
    const size_t c = (size_t)i * naz + j;
    const bool face = i >= 2 && i <= nr - 2;
    const bool ring = i >= 1 && i <= nr - 2;
    const int p = (a + 1) * SRC_PW + b + 1;   // here; p - SRC_PW below, p - 1 before

    // radial momentum, face i between rings i-1 and i (SourceEuler.cpp:325-372)
    if (face) {
      const int lo = p - SRC_PW;
      const T invdrm = col(cols, i, C_INVDRM);
      const T gradp =
          T(2) / (s_sig[p] + s_sig[lo]) * (s_press[p] - s_press[lo]) * invdrm;
      const T gradphi = (s_pot[p] - s_pot[lo]) * invdrm;
      const int jn = jnext(j, naz);
      const size_t r0 = (size_t)i * naz, r1 = (size_t)(i - 1) * naz;
      const T vsum = vaz[r0 + j] + vaz[r0 + jn] + vaz[r1 + j] + vaz[r1 + jn];
      const T vt = T(0.25) * vsum + col(cols, i, C_RA) * omega;
      const T cen = vt * vt * col(cols, i, C_INV_RA);
      vrad_out[c] = vrad[c] + dt * (-gradp - gradphi + cen);
    } else {
      vrad_out[c] = vrad[c];
    }

    // azimuthal momentum, ring i between cells j-1 and j (:375-428)
    if (ring) {
      const int prev = p - 1;
      const T invdxth = col(cols, i, C_SRC_INVDXTHETA);
      const T gradp = T(2) / (s_sig[p] + s_sig[prev]) *
                      (s_press[p] - s_press[prev]) * invdxth;
      const T gradphi = (s_pot[p] - s_pot[prev]) * invdxth;
      T v = vaz[c] + dt * (-gradp - gradphi);
      if (P.has_drift) v = v + dt * col(cols, i, C_DRIFT);
      vaz_out[c] = v;
    } else if (i < nr) {
      vaz_out[c] = vaz[c];
    }
  }
}

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  // fp: gamma, thickness smoothing, G, aspect ratio, flaring index
  const double gamma = fp[0];
  SrcParams<T> P{T(gamma - 1.0), T(gamma * (gamma - 1.0)), T(sqrt(gamma)),
                 T(fp[1]), T(fp[2]), T(fp[3]), 1.0 + fp[4],
                 ip[2], ip[3], ip[4], ip[5], ip[6], ip[7]};
  const int nr = ip[0], naz = ip[1];
  if (P.n_bodies < 1) return (int)cudaErrorInvalidValue;
  const int chunk = P.n_bodies < MAX_CHUNK ? P.n_bodies : MAX_CHUNK;
  const size_t smem = (size_t)(3 * SRC_PLANE + BODY_VALUES * chunk) * sizeof(T);
  static_assert((3 * SRC_PLANE + BODY_VALUES * MAX_CHUNK) * sizeof(double) <=
                    48 * 1024,
                "a chunk of bodies and the planes fit in 48 KB");
  const dim3 grid((naz + SRC_TW - 1) / SRC_TW, (nr + 1 + SRC_TH - 1) / SRC_TH);
  sources_kernel<T><<<grid, SRC_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      p[8], p[9], p[10], (const double*)p[11], (const double*)p[12], (const double*)p[13],
      (const double*)p[14], (const T*)p[17], P, nr, naz, (T*)p[15],
      (T*)p[16]);
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
