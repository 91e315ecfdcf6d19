// Device code shared by the FARGO transport kernels of the split route
// (radial_momenta_sweep.cu, fargo_theta.cu) and of the staged route
// (radial_sweep.cu, theta_sweep.cu): the radial helpers of the two radial
// sweeps (one thread per cell), and the azimuthal ring-tile kernel of the
// two azimuthal ops. The whole-transport kernel (transport.cu) tiles the
// same arithmetic its own way.
//
// The advected batch is (K, NR, NAZ), ordered [rp, rm, ap, am, (energy),
// sigma]: K = 6 adiabatic, 5 isothermal; entry K-1 is the density. The
// azimuthal ops take any K >= 1.
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

// The azimuthal sweeps as ring tiles (reference
// src/TransportEuler.cpp:630-664 VanLeerTheta with :416-466
// compute_star_theta, :171-268 OneWindTheta + UniformTransport +
// AdvectSHIFT).
//
// A block of TH_BLOCK threads holds a window of TH_WINDOW_F32 cells of
// ring i in float32 (TH_WINDOW_F64 in float64, fewer where a large K would
// not fit in shared memory): L = window - 4 S output cells j0..j0+L-1 and
// their halo, S the sweeps, so that each stage is a whole number of
// passes of the block's threads. Output cell j is the swept source cell
// c = j - s_i (s_i = 0 without the roll), and a sweep updates cell c from
// cells c-2..c+2, so the block loads source cells c0-2S..c0+L-1+2S
// (c0 = j0 - s_i, S the sweeps) of the K planes and of the sweep velocity
// into shared memory, wrapped round the ring as often as needed (a ring
// may be shorter than the halo). There, per sweep:
//   - one quotient by the pre-sweep density per cell and quantity (W);
//   - per interface m (between cells m-1 and m) one upwind value of the
//     density and of each quantity, the upwind cell b picked by index from
//     the sign of ksi = v dt, with the slope of cell b only, and the K
//     fluxes coef * star * density_star * v (F);
//   - the update q + (F[m] - F[m+1]) / surf, and the next sweep's
//     quotients by the swept density.
// The second sweep (fargo_theta with fast transport) moves every interface
// with the ring's uniform vconst[i]. The tile is then written out, rolled
// by where it was loaded. One launch an op; no batch leaves the block
// between the sweeps.
//
// The arithmetic is the plain version's (ops/transport.py theta_sweep)
// operation for operation: IEEE divisions, the slope divided by dxtheta,
// no fused multiply-add, each value computed once.
constexpr int TH_BLOCK = 256;       // threads a block
constexpr int TH_WINDOW_F32 = 512;  // cells a block holds, float32
constexpr int TH_WINDOW_F64 = 256;  // cells a block holds, float64
constexpr int TH_SMEM_MAX = 227 * 1024;   // what a block may ask for

namespace {

// K > 0 fixes the number of planes at compile time (5 and 6, the batch of
// the transport); K = 0 takes it from k_rt. Shared memory, all of it
// dynamic: Q, W, F (K planes each) and V, `stride` values each.
template <typename T, int K>
__global__ void __launch_bounds__(TH_BLOCK, 2)
theta_ring_kernel(const T* __restrict__ qin, const T* __restrict__ v,
                  const T* __restrict__ vconst, const int* __restrict__ nshift,
                  const T* __restrict__ cols, const T* __restrict__ scal,
                  double dphi, int nr, int naz, int k_rt, int kind,
                  int sweeps, int tile, int segments, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char th_smem[];
  const int nk = K > 0 ? K : k_rt;
  const int stride = tile + 4 * sweeps;
  T* Q = reinterpret_cast<T*>(th_smem);
  T* W = Q + nk * stride;
  T* F = W + nk * stride;
  T* V = F + nk * stride;
  T* Qs = Q + (nk - 1) * stride;   // the density plane
  T* Fs = F + (nk - 1) * stride;

  const int tid = threadIdx.x;
  const int i = blockIdx.x / segments;
  const int j0 = (blockIdx.x - i * segments) * tile;
  const int len = min(tile, naz - j0);
  const int halo = 2 * sweeps;
  const int n = len + 2 * halo;      // local cell m is source cell c0-halo+m
  const int shift = nshift ? wrap(nshift[i], naz) : 0;
  const int start = wrap(j0 - shift - halo, naz);
  const size_t row = (size_t)i * naz;
  const size_t plane = (size_t)nr * naz;
  const T dt = scal[0];

  for (int m = tid; m < n; m += TH_BLOCK) {
    int c = start + m;
    if (c >= naz) {
      c -= naz;
      if (c >= naz) c %= naz;          // a ring shorter than the tile's halo
    }
    const T sg = qin[(size_t)(nk - 1) * plane + row + c];
#pragma unroll
    for (int k = 0; k < nk; ++k) {
      const T q = qin[(size_t)k * plane + row + c];
      Q[k * stride + m] = q;
      W[k * stride + m] = q / sg;
    }
    V[m] = v[row + c];
  }
  __syncthreads();

  const T dxtheta = T(dphi) * col(cols, i, C_RB);
  const T coef = col(cols, i, C_COEF) * dt;
  const T inv_surf = col(cols, i, C_INV_SURF);
  const T vc = sweeps == 2 ? vconst[i] : T(0);
  for (int p = 0; p < sweeps; ++p) {
    const int lo = 2 + 2 * p;
    for (int m = lo + tid; m < n - 1 - 2 * p; m += TH_BLOCK) {
      const T vv = p == 1 ? vc : V[m];
      const T ksi = vv * dt;
      const bool up = ksi > T(0);
      const int b = up ? m - 1 : m;    // the upwind cell
      const T reach = up ? dxtheta - ksi : dxtheta + ksi;
      auto star = [&](const T* x) -> T {
        const T dq = T(0.5) * limiter(x[b + 1] - x[b], x[b] - x[b - 1], kind)
                     / dxtheta;
        const T t = reach * dq;
        return up ? x[b] + t : x[b] - t;
      };
      const T ds = star(Qs);
#pragma unroll
      for (int k = 0; k < nk; ++k)
        F[k * stride + m] = coef * star(W + k * stride) * ds * vv;
    }
    __syncthreads();
    for (int m = lo + tid; m < n - 2 - 2 * p; m += TH_BLOCK) {
      const T sn = Qs[m] + (Fs[m] - Fs[m + 1]) * inv_surf;
#pragma unroll
      for (int k = 0; k < nk; ++k) {
        const T* Fk = F + k * stride;
        const T qn = k == nk - 1 ? sn
                                 : Q[k * stride + m] + (Fk[m] - Fk[m + 1]) * inv_surf;
        Q[k * stride + m] = qn;
        if (p + 1 < sweeps) W[k * stride + m] = qn / sn;
      }
    }
    __syncthreads();
  }

  // out[k, i, j0 + t] is the swept source cell m = halo + t
  for (int t = tid; t < len; t += TH_BLOCK) {
#pragma unroll
    for (int k = 0; k < nk; ++k)
      out[(size_t)k * plane + row + j0 + t] = Q[k * stride + halo + t];
  }
}

// Launches theta_ring_kernel on `stream`: `sweeps` 1 or 2 (the second with
// the uniform vconst), the roll by nshift where it is not null, the
// result into out (K, NR, NAZ). Returns the CUDA error of the launch.
template <typename T>
int launch_theta_ring(const T* qin, const T* v, const T* vconst,
                      const int* nshift, const T* cols, const T* scal,
                      double dphi, int nr, int naz, int k, int kind,
                      int sweeps, T* out, cudaStream_t stream) {
  const size_t per_cell = (size_t)(3 * k + 1) * sizeof(T);
  int window = sizeof(T) == 4 ? TH_WINDOW_F32 : TH_WINDOW_F64;
  const int fit = (int)(TH_SMEM_MAX / per_cell);
  if (window > fit) window = fit;
  const int tile = window - 4 * sweeps;
  if (tile < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = per_cell * (size_t)window;
  auto kernel = k == 6 ? theta_ring_kernel<T, 6>
                : k == 5 ? theta_ring_kernel<T, 5> : theta_ring_kernel<T, 0>;
  if (smem > 48 * 1024) {              // more than a block gets unasked
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int segments = (naz + tile - 1) / tile;
  kernel<<<nr * segments, TH_BLOCK, smem, stream>>>(
      qin, v, vconst, nshift, cols, scal, dphi, nr, naz, k, kind, sweeps,
      tile, segments, out);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace fc
