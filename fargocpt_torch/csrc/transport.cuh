// Device code shared by the FARGO transport kernels of the split route
// (radial_momenta_sweep.cu, fargo_theta.cu) and of the staged route
// (radial_sweep.cu, theta_sweep.cu): the radial column march of the two
// radial ops and the azimuthal ring-tile kernel of the two azimuthal ops.
// The whole-transport kernel (transport.cu) tiles the same arithmetic its
// own way.
//
// The advected batch is (K, NR, NAZ), ordered [rp, rm, ap, am, (energy),
// sigma]: K = 6 adiabatic, 5 isothermal; entry K-1 is the density. The
// azimuthal ops and radial_sweep take any K >= 1.
#pragma once

#include "common.cuh"

namespace fc {

// The radial sweep as a column march (reference
// src/TransportEuler.cpp:545-620 VanLeerRadial with :349-406
// compute_star_radial).
//
// Bound: device memory; a launch must read its source planes, vrad and the
// sigma flux `base` once and write the K swept planes once. The flux through
// face f is star_f * base_f, star_f the limited upwind value of the
// specific quantity q / sigma; row i becomes q + (F_i - F_{i+1}) inv_surf_i.
// A thread owns column j and marches up a strip of MARCH_ROWS rows
// i0..i1-1, reading rows i0-2..i1+1 (clamped to the grid: a clamped row
// enters no value that is used) and faces i0..i1. It keeps in registers
// the window w[k][0..3] of specific values (rows f-2..f+1 of face f) and
// the quantities of the last three rows, so that:
//   - each row's quantities and their K quotients by sigma are made once;
//   - each face's vrad and base are read once and its flux is evaluated
//     once, with the limited slope of the upwind row only (the sign of
//     vrad picks it; zero outside rows 1..NR-2), then carried to the row
//     below it as that row's lower flux;
//   - faces 0 and NR carry 0 * base, the signed zero of the plain version.
// Reads and writes are contiguous along j. The source policy says where a
// row's K quantities come from: MarchFields builds [rp, rm, ap, am,
// (energy), sigma] from the transport's input fields (reference
// src/TransportEuler.cpp:471-493 compute_momenta_from_velocities; the
// momenta never exist in device memory) and divides by the built sigma;
// MarchBatch reads plane k of a given batch and divides by a separate
// pre-sweep sigma. K = 5 and 6 (the transport's batch) are marched at
// once; K = 0 takes the batch's planes one by one (any K), re-reading
// sigma, vrad and base for each.
//
// The arithmetic is the plain version's (ops/transport.py radial_sweep)
// operation for operation: IEEE divisions, no fused multiply-add, the
// momenta as sig * (v + corot) * rb, the quotient of the built momentum by
// sigma (never vrad itself), the slope term as (cm - vr dt) * 0.5 * dq.
constexpr int MARCH_ROWS = 16;    // rows a thread marches over
constexpr int MARCH_BLOCK = 128;  // columns (threads) a block
// blocks of MARCH_BLOCK threads a multiprocessor must hold in float32
// (__launch_bounds__): 7 holds a thread to 72 registers; asked for 1, the
// compiler took 83-86 at K = 6, 5 blocks fitted and the march ran 20-25%
// slower on an H100 (PERF.md, PR 8). float64 asks for 1 and takes 130-152
// registers with no spill.
constexpr int MARCH_MIN_BLOCKS_F32 = 7;

// the quantities of the transport's input fields, K = 6 adiabatic, 5
// isothermal; scal = [dt, omega_frame]
template <typename T, int K>
struct MarchFields {
  static_assert(K == 5 || K == 6, "the momenta batch has 5 or 6 planes");
  const T* sigma;
  const T* vrad;
  const T* vaz;
  const T* energy;
  const T* cols;
  T omega;

  __device__ __forceinline__ void begin(const T* scal) { omega = scal[1]; }

  // q[0..K-1] of row r, column j; returns the divisor (sigma of the row)
  template <int NQ>
  __device__ __forceinline__ T load(int r, int j, int p0, int naz,
                                    size_t plane, T (&q)[NQ]) const {
    static_assert(NQ == K, "the fields are marched as one batch");
    (void)p0;
    (void)plane;
    const size_t row = (size_t)r * naz;
    const T sig = __ldg(sigma + row + j);
    const T rb = col(cols, r, C_RB);
    const T corot = rb * omega;
    q[0] = sig * __ldg(vrad + row + naz + j);
    q[1] = sig * __ldg(vrad + row + j);
    q[2] = sig * (__ldg(vaz + row + jnext(j, naz)) + corot) * rb;
    q[3] = sig * (__ldg(vaz + row + j) + corot) * rb;
    if (K == 6) q[4] = __ldg(energy + row + j);
    q[K - 1] = sig;
    return sig;
  }
};

// planes p0..p0+NQ-1 of a given batch qs (K, NR, NAZ), divided by the
// separate pre-sweep density sigma (NR, NAZ); scal = [dt]
template <typename T>
struct MarchBatch {
  const T* qs;
  const T* sigma;

  __device__ __forceinline__ void begin(const T*) {}

  template <int NQ>
  __device__ __forceinline__ T load(int r, int j, int p0, int naz,
                                    size_t plane, T (&q)[NQ]) const {
    const size_t c = (size_t)r * naz + j;
#pragma unroll
    for (int k = 0; k < NQ; ++k) q[k] = __ldg(qs + (size_t)(p0 + k) * plane + c);
    return __ldg(sigma + c);
  }
};

namespace {

// K > 0 marches the K planes at once; K = 0 marches the k_rt planes of a
// batch one at a time.
template <typename T, int K, class Src>
__global__ void __launch_bounds__(MARCH_BLOCK,
                                  sizeof(T) == 4 ? MARCH_MIN_BLOCKS_F32 : 1)
radial_march_kernel(Src src, const T* __restrict__ vrad,
                    const T* __restrict__ base, const T* __restrict__ cols,
                    const T* __restrict__ scal, int nr, int naz, int k_rt,
                    int kind, int col_blocks, T* __restrict__ out) {
  constexpr int NQ = K > 0 ? K : 1;    // planes a march carries
  const int strip = blockIdx.x / col_blocks;
  const int j = (blockIdx.x - strip * col_blocks) * MARCH_BLOCK + threadIdx.x;
  if (j >= naz) return;
  const int i0 = strip * MARCH_ROWS;
  const int i1 = min(i0 + MARCH_ROWS, nr);     // the strip is rows i0..i1-1
  const size_t plane = (size_t)nr * naz;
  const int nk = K > 0 ? K : k_rt;
  const T dt = scal[0];
  src.begin(scal);

  for (int p0 = 0; p0 < nk; p0 += NQ) {
    // at row r of the march: q[k][0..2] the quantities of rows r-2..r,
    // w[k][0..3] their quotients by sigma for rows r-3..r, the window
    // f-2..f+1 of face f = r - 1; f_low[k] the flux through face f - 1
    T q[NQ][3], w[NQ][4], f_low[NQ];
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      f_low[k] = T(0);
#pragma unroll
      for (int d = 0; d < 3; ++d) q[k][d] = T(0);
#pragma unroll
      for (int d = 0; d < 4; ++d) w[k][d] = T(0);
    }

    for (int r = i0 - 2; r <= i1 + 1; ++r) {
      T fresh[NQ];
      const T sig = src.load(clampi(r, 0, nr - 1), j, p0, naz, plane, fresh);
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        q[k][0] = q[k][1];
        q[k][1] = q[k][2];
        q[k][2] = fresh[k];
        w[k][0] = w[k][1];
        w[k][1] = w[k][2];
        w[k][2] = w[k][3];
        w[k][3] = fresh[k] / sig;
      }
      const int f = r - 1;
      if (f < i0) continue;

      const size_t at = (size_t)f * naz + j;
      const T bf = __ldg(base + at);
      T fl[NQ];
      if (f >= 1 && f <= nr - 1) {
        const T vr = __ldg(vrad + at);
        const bool up = vr > T(0);
        const int b = up ? f - 1 : f;            // the upwind row
        const bool sloped = b >= 1 && b <= nr - 2;
        const T inv_lo = col(cols, b, C_INVDRM);
        const T inv_hi = col(cols, b + 1, C_INVDRM);
        const T reach = (up ? col(cols, f, C_CM) - vr * dt
                            : col(cols, f, C_CP) + vr * dt) * T(0.5);
#pragma unroll
        for (int k = 0; k < NQ; ++k) {
          // the upwind row's value m and its neighbours a (below), p (above)
          const T a = up ? w[k][0] : w[k][1];
          const T m = up ? w[k][1] : w[k][2];
          const T p = up ? w[k][2] : w[k][3];
          T dq = T(0);
          if (sloped) dq = limiter((p - m) * inv_hi, (m - a) * inv_lo, kind);
          const T t = reach * dq;
          fl[k] = (up ? m + t : m - t) * bf;
        }
      } else {
#pragma unroll
        for (int k = 0; k < NQ; ++k) fl[k] = T(0) * bf;
      }
      if (f > i0) {
        const int i = f - 1;                     // the row below face f
        const T inv_surf = col(cols, i, C_INV_SURF);
        const size_t o = (size_t)i * naz + j;
#pragma unroll
        for (int k = 0; k < NQ; ++k)
          out[(size_t)(p0 + k) * plane + o] =
              q[k][0] + (f_low[k] - fl[k]) * inv_surf;
      }
#pragma unroll
      for (int k = 0; k < NQ; ++k) f_low[k] = fl[k];
    }
  }
}

// Launches radial_march_kernel<T, K, Src> on `stream` over the strips and
// column blocks of an (NR, NAZ) grid; k_rt is the batch's K where K = 0.
// Returns the CUDA error of the launch.
template <typename T, int K, class Src>
int launch_radial_march(const Src& src, const T* vrad, const T* base,
                        const T* cols, const T* scal, int nr, int naz,
                        int k_rt, int kind, T* out, cudaStream_t stream) {
  const int col_blocks = (naz + MARCH_BLOCK - 1) / MARCH_BLOCK;
  const int strips = (nr + MARCH_ROWS - 1) / MARCH_ROWS;
  radial_march_kernel<T, K, Src><<<col_blocks * strips, MARCH_BLOCK, 0,
                                   stream>>>(src, vrad, base, cols, scal, nr,
                                             naz, k_rt, kind, col_blocks, out);
  return (int)cudaGetLastError();
}

}  // namespace

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
