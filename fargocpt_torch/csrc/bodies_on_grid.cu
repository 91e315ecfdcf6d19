// The bodies as the gas sees them: each body's ramped mass, its
// dimensionless Roche radius and its cubic smoothing radius.
//
// Replaces no Pallas kernel: the JAX package leaves this to XLA
// (fargocpt_tpu/step.py bodies_on_grid, fargocpt_tpu/nbody/system.py).
// Its plain version is fargocpt_torch/nbody/system.py: rampup_masses (the
// reference's src/nbody/planet.cpp:166-179), dimensionless_roche_radius
// (12 Newton iterations for the L1 point, src/Theo.cpp:251-277) and
// dist_to_primary, which HydroStep.bodies_on_grid combines. As PyTorch ops
// on (N,) tensors that is ~280 launches a call, twice an Euler step with
// planets, each on three elements, and the device idles while the host
// enqueues them.
//
// What bounds it: neither bytes (5 N doubles in, 3 N out) nor operations
// (~200 a body) -- the launch latency and one thread's chain of dependent
// float64 operations. Design: a thread a body, a grid-stride loop (any
// N >= 1), every intermediate in registers; time is a kernel argument or
// one value on the device (the run type: float or double), never read on
// the host.
//
// The arithmetic follows the plain version on the card operation by
// operation (the library is built with --fmad=false and without fast
// math): ATen's x**2 and x**3 are the products x*x and (x*x)*x, its
// clamps keep a NaN, its sign is (0 < r) - (r < 0), every division by a
// tensor is an IEEE division, pow and cos are libdevice's, and pi / 2 is
// folded on the host as Python folds it.
//
// ptrs: x, y, mass (float64, N each), ramp_time (float64, N; null: no
//       ramp), cubic_factor (float64, N; null: no cubic smoothing, the
//       radius is 0), time (one value of the type ip[2] names; null: fp[0]),
//       mass_out, roche_out, cubic_out (float64, N each)
// fp:   time (read when the pointer is null), pi / 2
// ip:   N (>= 1), 1, time on the device: 0 none, 1 float, 2 double
#include "common.cuh"

namespace fc {
namespace {

constexpr int N_NEWTON = 12;
constexpr int BODY_BLOCK = 128;
constexpr int BODY_MAX_BLOCKS = 64;

// torch.clamp: a NaN stays NaN
__device__ __forceinline__ double clamp_keep_nan(double v, double lo,
                                                 double hi) {
  return isnan(v) ? v : fmin(fmax(v, lo), hi);
}

// dimensionless_roche_radius for one body: the L1 distance as a fraction
// of the distance to the primary of mass mc
template <int ITER>
__device__ __forceinline__ double roche_fraction(double mc, double mo) {
  const double q = mc / (mc + mo);
  const double c3 = 3.0 * mc;
  const double ratio = mo / (isnan(c3) ? c3 : fmax(c3, 1e-300));
  const double sgn = (double)((0.0 < ratio) - (ratio < 0.0));
  double x = clamp_keep_nan(sgn * pow(fabs(ratio), 1.0 / 3.0), 1e-8, 0.9);
  const double p = 1.0 - q;
#pragma unroll 1
  for (int it = 0; it < ITER; ++it) {
    const double om = 1.0 - x;
    const double om2 = om * om;
    const double x2 = x * x;
    const double f = (((q / om2) - (p / x2)) - q) + x;
    const double df = (((2.0 * q) / (om2 * om)) + ((2.0 * p) / (x2 * x)))
                      + 1.0;
    x = x - (f / df);
  }
  return x;
}

// A template, like every kernel of the library, so that the profiler names
// it "void fc::..." and never with the "fc:" prefix of the spans' ranges.
template <typename TTime, int ITER>
__global__ void __launch_bounds__(BODY_BLOCK)
bodies_on_grid_kernel(const double* __restrict__ x,
                      const double* __restrict__ y,
                      const double* __restrict__ mass,
                      const double* __restrict__ ramp_time,
                      const double* __restrict__ cubic_factor,
                      const TTime* __restrict__ time_ptr, double time_arg,
                      double half_pi, int n, double* __restrict__ mass_out,
                      double* __restrict__ roche_out,
                      double* __restrict__ cubic_out) {
  const double t = time_ptr != nullptr ? (double)time_ptr[0] : time_arg;
  const double mc = mass[0];
  const double x0 = x[0], y0 = y[0];
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const double mo = mass[k];

    // rampup_masses: 1 - cos(t (pi/2) / T)^2 while 0 < t < T
    double frac = 1.0;
    if (ramp_time != nullptr) {
      const double rt = ramp_time[k];
      if (rt > 0.0 && t < rt) {
        const double c = cos((t * half_pi) / rt);
        frac = 1.0 - c * c;
      }
    }
    mass_out[k] = mo * frac;

    // the primary's Roche radius is 0
    const double roche = k == 0 ? 0.0 : roche_fraction<ITER>(mc, mo);
    roche_out[k] = roche;

    double cubic = 0.0;
    if (cubic_factor != nullptr) {
      const double dx = x[k] - x0;
      const double dy = y[k] - y0;
      cubic = (roche * sqrt((dx * dx) + (dy * dy))) * cubic_factor[k];
    }
    cubic_out[k] = cubic;
  }
}

template <typename TTime>
int launch(void* const* p, const double* fp, int n, void* stream) {
  const int needed = (n + BODY_BLOCK - 1) / BODY_BLOCK;
  const int blocks = needed < BODY_MAX_BLOCKS ? needed : BODY_MAX_BLOCKS;
  bodies_on_grid_kernel<TTime, N_NEWTON>
      <<<blocks, BODY_BLOCK, 0, (cudaStream_t)stream>>>(
      (const double*)p[0], (const double*)p[1], (const double*)p[2],
      (const double*)p[3], (const double*)p[4], (const TTime*)p[5], fp[0],
      fp[1], n, (double*)p[6], (double*)p[7], (double*)p[8]);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

extern "C" {
int fc_bodies_on_grid_f64(void* const* p, const double* fp, const int* ip,
                          void* s) {
  const int n = ip[0];
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (ip[2] == 1) return fc::launch<float>(p, fp, n, s);
  if (ip[2] == 2 || p[5] == nullptr) return fc::launch<double>(p, fp, n, s);
  return (int)cudaErrorInvalidValue;
}
}
