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
// Bound, as measured on an H100 (PERF.md, Findings): arithmetic (the
// operations a thread executes), not device memory. With one thread per
// cell and stage (four launches over two scratch batches, ~600 MB of
// traffic at 1024x3072 float32) the substep ran at a seventh of the card's
// memory rate: every thread divided q / sigma for its five stencil cells
// of each quantity, each interface's upwind value was built twice (once
// from either side) with both limited slopes, and the indices took 64-bit
// divisions. So this kernel derives each value once, builds each interface
// once with the upwind slope only, and keeps the batch out of device
// memory between the azimuthal stages. Three launches:
//   1. radial (tr_radial_kernel): a thread owns a column j and marches up a
//      strip of RAD_ROWS rows with the four-row window of specific values
//      (rows f-2..f+1 of face f) in registers. A row's momenta and their
//      quotients by sigma are derived once, the flux through face f is the
//      upper flux of row f-1 and the lower flux of row f, and only the
//      slope on the upwind side (the sign of vrad) is evaluated. Writes the
//      swept batch (K, NR, NAZ) and the mass flux. Reads and writes are
//      contiguous along j.
//   2. ring (tr_ring_kernel): a block takes RingTile::L output cells of one
//      ring. Output cell j comes from source cell c = j - s_i, so the
//      block loads source cells c0-5..c0+L+3 (two sweeps reach c-4..c+4,
//      vaz_out needs cell c-1 as well; c0-3..c0+L+1 for one sweep) of the K
//      planes and of the sweep velocity into shared memory, wrapped round
//      the ring as often as needed. There: one quotient by the pre-sweep
//      density per cell and quantity; per interface one upwind value of the
//      density and of each quantity (the upwind cell is picked by index, so
//      the residual sweep does not diverge); the update; the second sweep
//      on the result with the once-swept density; then sigma, energy and
//      vaz go out from shared memory together with the rolled rp plane
//      (scratch) and the rolled rm plane (into vrad_out's rows).
//   3. vrad (tr_vrad_kernel): vrad_out[i] = (rp[i-1] + rm[i]) /
//      (sigma_out[i-1] + sigma_out[i]) needs the ring below at that ring's
//      own shift, so it is a last elementwise launch over the rolled
//      planes; row 0 is zero and row NR keeps its value.
// Device traffic at 1024x3072 float32, K = 6: 138 + 151 + 63 MB.
//
// The arithmetic is the plain version's operation for operation: IEEE
// divisions, no fused multiply-add, the same order of the products, each
// value only computed once; with one exception. The azimuthal slopes'
// division by the ring's cell length dxtheta (K + 1 divisions per interface
// and sweep by a number that is one per ring) is a multiplication by
// 1 / dxtheta taken once a block. On an H100 at 1024x3072 float32 that took
// the ring stage from 0.2136 to 0.1415 ms; 166 values of sigma, 212 of vaz,
// 367 of energy and 45939 of vrad (of 3.1 million each) moved, by at most
// one unit in the last place (PERF.md, Findings). The divisions by the
// density and inside the van Leer slope stay IEEE divisions.
//
// The shift s_i = floor(ntilde + 0.5) and the residual velocity are inputs
// (computed once by the caller), so the kernel and the tensor version can
// be fed the same shift. dt (field type) and omega_frame (float64) are
// read from the device.
#include "common.cuh"

namespace fc {
namespace {

struct TrParams {
  double dphi;
  int limiter, fast;
};

constexpr int RAD_BLOCK = 128;   // columns per block of the radial stage
constexpr int RAD_ROWS = 16;     // rows a thread marches over
constexpr int RING_BLOCK = 256;  // threads per block of the ring stage

// output cells per block of the ring stage: (3 K + 1) (L + 9) values of
// shared memory, 39.6 KB in float32 and 40.3 KB in float64 for K = 6
template <typename T> struct RingTile { static constexpr int L = 512; };
template <> struct RingTile<double> { static constexpr int L = 256; };

// the K quantities [rp, rm, ap, am, (energy), sigma] of cell (r, j) from the
// transport's input fields (reference src/TransportEuler.cpp:471-493
// compute_momenta_from_velocities); jn is the column after j on the ring
template <typename T, int K>
__device__ __forceinline__ void momenta(const T* __restrict__ sigma,
                                        const T* __restrict__ vrad,
                                        const T* __restrict__ vaz,
                                        const T* __restrict__ energy,
                                        const T* __restrict__ cols, T omega,
                                        int r, int j, int jn, int naz,
                                        T (&q)[K]) {
  const size_t row = (size_t)r * naz;
  const T sig = sigma[row + j];
  const T rb = col(cols, r, C_RB);
  const T corot = rb * omega;
  q[0] = sig * vrad[row + naz + j];
  q[1] = sig * vrad[row + j];
  q[2] = sig * (vaz[row + jn] + corot) * rb;
  q[3] = sig * (vaz[row + j] + corot) * rb;
  if (K == 6) q[4] = energy[row + j];
  q[K - 1] = sig;
}

template <typename T, int K>
__global__ void __launch_bounds__(RAD_BLOCK)
tr_radial_kernel(const T* __restrict__ sigma, const T* __restrict__ vrad,
                 const T* __restrict__ vaz, const T* __restrict__ energy,
                 const T* __restrict__ cols, const T* __restrict__ dt_p,
                 const double* __restrict__ omega_p, TrParams P, int nr,
                 int naz, int col_blocks, T* __restrict__ qa,
                 T* __restrict__ flux) {
  const int strip = blockIdx.x / col_blocks;
  const int j = (blockIdx.x - strip * col_blocks) * RAD_BLOCK + threadIdx.x;
  if (j >= naz) return;
  const int jn = j == naz - 1 ? 0 : j + 1;
  const int i0 = strip * RAD_ROWS;
  const int i1 = min(i0 + RAD_ROWS, nr);       // the strip is rows i0..i1-1
  const size_t plane = (size_t)nr * naz;
  const T dt = dt_p[0];
  const T omega = (T)omega_p[0];
  const T dtdphi = dt * T(P.dphi);

  // at row r of the march: q[k][0..2] the quantities of rows r-2..r,
  // w[k][0..3] their quotients by sigma for rows r-3..r, which is the
  // window f-2..f+1 of face f = r - 1; s_low the density of row r-3
  T q[K][3], w[K][4], s_low = T(0), f_low[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    f_low[k] = T(0);
    for (int d = 0; d < 3; ++d) q[k][d] = T(0);
    for (int d = 0; d < 4; ++d) w[k][d] = T(0);
  }

  for (int r = i0 - 2; r <= i1 + 1; ++r) {
    s_low = q[K - 1][0];
    T fresh[K];
    momenta<T, K>(sigma, vrad, vaz, energy, cols, omega,
                  clampi(r, 0, nr - 1), j, jn, naz, fresh);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      q[k][0] = q[k][1];
      q[k][1] = q[k][2];
      q[k][2] = fresh[k];
      w[k][0] = w[k][1];
      w[k][1] = w[k][2];
      w[k][2] = w[k][3];
      w[k][3] = fresh[k] / fresh[K - 1];
    }
    const int f = r - 1;
    if (f < i0) continue;

    // the K fluxes through face f; faces 0 and NR carry nothing (a zero
    // with the sign of vrad, as the product of the plain version leaves it)
    T fl[K];
    const T vr = vrad[(size_t)f * naz + j];
#pragma unroll
    for (int k = 0; k < K; ++k) fl[k] = T(0) * vr;
    if (f >= 1 && f <= nr - 1) {
      const bool up = vr > T(0);
      // the upwind row: its slope is zero outside rows 1..NR-2
      const int rb_ = up ? f - 1 : f;
      const bool sloped = rb_ >= 1 && rb_ <= nr - 2;
      const T inv_lo = col(cols, rb_, C_INVDRM);
      const T inv_hi = col(cols, rb_ + 1, C_INVDRM);
      const T reach = (up ? col(cols, f, C_CM) - vr * dt
                          : col(cols, f, C_CP) + vr * dt) * T(0.5);
      // upwind face value from the upwind row's value m and its
      // neighbours a (below) and p (above)
      auto star = [&](T a, T m, T p) -> T {
        T dq = T(0);
        if (sloped) dq = limiter((p - m) * inv_hi, (m - a) * inv_lo, P.limiter);
        const T t = reach * dq;
        return up ? m + t : m - t;
      };
      const T ds = up ? star(s_low, q[K - 1][0], q[K - 1][1])
                      : star(q[K - 1][0], q[K - 1][1], q[K - 1][2]);
      const T ra = col(cols, f, C_RA);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T st = up ? star(w[k][0], w[k][1], w[k][2])
                        : star(w[k][1], w[k][2], w[k][3]);
        fl[k] = dtdphi * ra * st * ds * vr;
      }
    }
    if (f < i1 || f == nr) flux[(size_t)f * naz + j] = fl[K - 1];
    if (f > i0) {
      const int i = f - 1;                     // the cell below face f
      const T inv_surf = col(cols, i, C_INV_SURF);
      const size_t o = (size_t)i * naz + j;
#pragma unroll
      for (int k = 0; k < K; ++k)
        qa[(size_t)k * plane + o] = q[k][0] + (f_low[k] - fl[k]) * inv_surf;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) f_low[k] = fl[k];
  }
}

// (two blocks a multiprocessor as the bound: without it the compiler holds
// the float64 kernel to 48 registers and spills)
template <typename T, int K>
__global__ void __launch_bounds__(RING_BLOCK, 2)
tr_ring_kernel(const T* __restrict__ qa, const T* __restrict__ vaz,
               const T* __restrict__ vmean, const T* __restrict__ vconst,
               const int* __restrict__ nshift, const T* __restrict__ energy,
               const T* __restrict__ cols, const T* __restrict__ dt_p,
               const double* __restrict__ omega_p, TrParams P, int nr,
               int naz, int segments, T* __restrict__ sigma_out,
               T* __restrict__ vaz_out, T* __restrict__ energy_out,
               T* __restrict__ rp_out, T* __restrict__ rm_out) {
  constexpr int L = RingTile<T>::L;
  constexpr int NMAX = L + 9;
  // Q the quantities, W their quotients by the density, F the fluxes
  // through the cells' lower interfaces, V the residual sweep's velocity
  __shared__ T Q[K][NMAX], W[K][NMAX], F[K][NMAX], V[NMAX];

  const int tid = threadIdx.x;
  const int i = blockIdx.x / segments;
  const int j0 = (blockIdx.x - i * segments) * L;
  const int len = min(L, naz - j0);
  const int sweeps = P.fast ? 2 : 1;
  const int halo = 2 * sweeps + 1;     // source cells below the first output's
  const int n = len + 4 * sweeps + 1;  // local cell m is source cell c0-halo+m
  const int start = wrap(j0 - wrap(nshift[i], naz) - halo, naz);
  const size_t row = (size_t)i * naz;
  const size_t plane = (size_t)nr * naz;
  const T dt = dt_p[0];
  const T vm = vmean[i], vc = vconst[i];

  for (int m = tid; m < n; m += RING_BLOCK) {
    int c = start + m;
    if (c >= naz) {
      c -= naz;
      if (c >= naz) c %= naz;          // a ring shorter than the tile's halo
    }
    T qv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) qv[k] = qa[(size_t)k * plane + row + c];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      Q[k][m] = qv[k];
      W[k][m] = qv[k] / qv[K - 1];
    }
    const T vres = vaz[row + c] - vm;
    V[m] = P.fast ? vres : vres + vc;
  }
  __syncthreads();

  const T dxtheta = T(P.dphi) * col(cols, i, C_RB);
  const T inv_dx = T(1) / dxtheta;     // see the note on arithmetic above
  const T coef = col(cols, i, C_COEF) * dt;
  const T inv_surf = col(cols, i, C_INV_SURF);
  for (int p = 0; p < sweeps; ++p) {
    const int lo = 2 + 2 * p;
    // interface m lies between cells m-1 and m (reference
    // src/TransportEuler.cpp:416-466, :630-664); the second sweep moves
    // every interface with the ring's uniform velocity
    for (int m = lo + tid; m < n - 1 - 2 * p; m += RING_BLOCK) {
      const T v = p == 1 ? vc : V[m];
      const T ksi = v * dt;
      const bool up = ksi > T(0);
      const int b = up ? m - 1 : m;    // the upwind cell
      const T reach = up ? dxtheta - ksi : dxtheta + ksi;
      auto star = [&](const T* x) -> T {
        const T dq = T(0.5) * limiter(x[b + 1] - x[b], x[b] - x[b - 1],
                                      P.limiter) * inv_dx;
        const T t = reach * dq;
        return up ? x[b] + t : x[b] - t;
      };
      const T ds = star(Q[K - 1]);
#pragma unroll
      for (int k = 0; k < K; ++k) F[k][m] = coef * star(W[k]) * ds * v;
    }
    __syncthreads();
    for (int m = lo + tid; m < n - 2 - 2 * p; m += RING_BLOCK) {
      T qn[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        qn[k] = Q[k][m] + (F[k][m] - F[k][m + 1]) * inv_surf;
        Q[k][m] = qn[k];
      }
      if (p + 1 < sweeps) {
#pragma unroll
        for (int k = 0; k < K; ++k) W[k][m] = qn[k] / qn[K - 1];
      }
    }
    __syncthreads();
  }

  // out[i, j0 + t] is the swept source cell m = halo + t (reference
  // src/TransportEuler.cpp:238-268, :498-535)
  const T omega = (T)omega_p[0];
  const T rb = col(cols, i, C_RB);
  const T inv_rb = col(cols, i, C_INV_RB);
  for (int t = tid; t < len; t += RING_BLOCK) {
    const int m = halo + t;
    const size_t o = row + j0 + t;
    const T s_here = Q[K - 1][m];
    sigma_out[o] = s_here;
    energy_out[o] = K == 6 ? Q[4][m] : energy[o];
    vaz_out[o] = (Q[2][m - 1] + Q[3][m]) / (Q[K - 1][m - 1] + s_here) * inv_rb -
                 rb * omega;
    rp_out[o] = Q[0][m];
    rm_out[o] = Q[1][m];
  }
}

// vrad_out's rows 0..NR-1 hold the rolled rm plane on entry
template <typename T>
__global__ void tr_vrad_kernel(const T* __restrict__ rp,
                               const T* __restrict__ sigma_out,
                               const T* __restrict__ vrad, int nr, int naz,
                               int col_blocks, T* vrad_out) {
  const int i = blockIdx.x / col_blocks;
  const int j = (blockIdx.x - i * col_blocks) * BLOCK + threadIdx.x;
  if (j >= naz) return;
  const size_t idx = (size_t)i * naz + j;
  if (i == nr) {
    vrad_out[idx] = vrad[idx];
  } else if (i == 0) {
    vrad_out[idx] = T(0);
  } else {
    vrad_out[idx] = (rp[idx - naz] + vrad_out[idx]) /
                    (sigma_out[idx - naz] + sigma_out[idx]);
  }
}

template <typename T, int K>
int run(void* const* p, TrParams P, int nr, int naz, cudaStream_t s) {
  const T* sigma = (const T*)p[0];
  const T* vrad = (const T*)p[1];
  const T* vaz = (const T*)p[2];
  const T* energy = (const T*)p[3];
  const T* cols = (const T*)p[4];
  const T* dt = (const T*)p[5];
  const double* omega = (const double*)p[6];
  const T* vmean = (const T*)p[7];
  const int* nshift = (const int*)p[8];
  const T* vconst = (const T*)p[9];
  T* sigma_out = (T*)p[10];
  T* vrad_out = (T*)p[11];
  T* vaz_out = (T*)p[12];
  T* energy_out = (T*)p[13];
  T* flux = (T*)p[14];
  T* qa = (T*)p[15];     // scratch (K, NR, NAZ): the radially swept batch
  T* rp = (T*)p[16];     // scratch (NR, NAZ): the rolled rp plane

  const int rad_cols = (naz + RAD_BLOCK - 1) / RAD_BLOCK;
  const int strips = (nr + RAD_ROWS - 1) / RAD_ROWS;
  tr_radial_kernel<T, K><<<rad_cols * strips, RAD_BLOCK, 0, s>>>(
      sigma, vrad, vaz, energy, cols, dt, omega, P, nr, naz, rad_cols, qa,
      flux);
  const int segments = (naz + RingTile<T>::L - 1) / RingTile<T>::L;
  tr_ring_kernel<T, K><<<nr * segments, RING_BLOCK, 0, s>>>(
      qa, vaz, vmean, vconst, nshift, energy, cols, dt, omega, P, nr, naz,
      segments, sigma_out, vaz_out, energy_out, rp, vrad_out);
  const int col_blocks = (naz + BLOCK - 1) / BLOCK;
  tr_vrad_kernel<T><<<(nr + 1) * col_blocks, BLOCK, 0, s>>>(
      rp, sigma_out, vrad, nr, naz, col_blocks, vrad_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  const TrParams P{fp[0], ip[3], ip[4]};
  const int nr = ip[0], naz = ip[1];
  cudaStream_t s = (cudaStream_t)stream;
  return ip[2] ? run<T, 6>(p, P, nr, naz, s) : run<T, 5>(p, P, nr, naz, s);
}

}  // namespace
}  // namespace fc

// ptrs: sigma, vrad, vaz, energy, cols, dt (1), omega_frame (1, float64),
//       vmean (NR, 1), nshift (NR, int32), vconst (NR, 1), sigma_out,
//       vrad_out, vaz_out, energy_out, mass flux (NR+1, NAZ),
//       scratch (K, NR, NAZ), scratch (NR, NAZ)
// fp:   dphi
// ip:   NR, NAZ, adiabatic, flux limiter (0 van Leer, 1 MC), fast transport
extern "C" {
int fc_transport_f32(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_transport_f64(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
