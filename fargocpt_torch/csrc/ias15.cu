// One whole IAS15 call of the N-body integrator on the device.
//
// Replaces no Pallas kernel: the JAX package runs the adaptive 15th-order
// Gauss-Radau integrator (Rein & Spiegel 2015) as one lax.while_loop on
// the device (fargocpt_tpu/nbody/ias15.py:236 integrate_ias15). Its plain
// PyTorch version, fargocpt_torch/nbody/ias15.py, is a Python loop of
// (N,)-sized ops with a host read per corrector test and per substep:
// hundreds of launches per trial step, twice a hydro step with planets
// (the indirect term's predictor and the drift).
//
// What bounds it: neither bytes (5 N doubles in, 4 N out) nor operations
// (a few thousand per trial step) -- the launch latency and the chain of
// dependent float64 operations of one thread. Design: one block of one
// thread runs the whole call, its substeps, its corrector iterations and
// the step-size control, and never returns to the host. Its per-body
// arrays (33 of 2N values) are the thread's own, in registers and local
// memory, up to MAX_BODIES = 16 bodies; beyond, they are rows of a
// float64 workspace in device memory that the wrapper allocates, so any
// N >= 2 runs, in the same order of arithmetic. The arithmetic follows the plain version
// operation for operation (compiled with --fmad=false, as the whole
// library is; d^-3 as 1 / (d^2 sqrt(d^2)) and the step ratio's powers as
// successive products in both; pow only for the step-size control's
// seventh root), so the two agree to rounding and take the same
// substeps; sums over the bodies run in index order.
#include "common.cuh"

#include <cfloat>

namespace fc {
namespace {

constexpr int MAX_BODIES = 16;
constexpr int MAXQ = 2 * MAX_BODIES;   // x and y of every body
constexpr double SAFETY = 0.25;
constexpr int MAX_PC_ITER = 12;
constexpr int MAX_SUBSTEPS = 4096;

// the Gauss-Radau spacings (nodes of the 8-point Radau IIA quadrature)
__constant__ double H_NODES[8] = {
    0.0,
    0.0562625605369221464656521910318,
    0.180240691736892364987579942780,
    0.352624717113169637373907769648,
    0.547153626330555383001448554766,
    0.734210177215410531523210605558,
    0.885320946839095768090359771030,
    0.977520613561287501891174488626,
};
__constant__ double XW[7] = {6.0, 12.0, 20.0, 30.0, 42.0, 56.0, 72.0};
__constant__ double VW[7] = {2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0};
__constant__ double PASCAL[7][7] = {
    {1., 2., 3., 4., 5., 6., 7.},
    {0., 1., 3., 6., 10., 15., 21.},
    {0., 0., 1., 4., 10., 20., 35.},
    {0., 0., 0., 1., 5., 15., 35.},
    {0., 0., 0., 0., 1., 6., 21.},
    {0., 0., 0., 0., 0., 1., 7.},
    {0., 0., 0., 0., 0., 0., 1.},
};

struct Tables {
  double rr[28];      // h[n] - h[m], divided-difference order
  double c[8][8];     // g -> b
  double d[8][8];     // b -> g
};

// Everhart's recurrences, in the order of nbody/ias15.py
__device__ void make_tables(Tables& t) {
  int k = 0;
  for (int n = 1; n < 8; ++n)
    for (int m = 0; m < n; ++m) t.rr[k++] = H_NODES[n] - H_NODES[m];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) {
      t.c[i][j] = i == j ? 1.0 : 0.0;
      t.d[i][j] = i == j ? 1.0 : 0.0;
    }
  for (int i = 1; i < 8; ++i) {
    t.c[i][0] = -H_NODES[i] * t.c[i - 1][0];
    t.d[i][0] = H_NODES[1] * t.d[i - 1][0];
    for (int j = 1; j < i; ++j) {
      t.c[i][j] = t.c[i - 1][j - 1] - H_NODES[i] * t.c[i - 1][j];
      t.d[i][j] = t.d[i - 1][j - 1] + H_NODES[j + 1] * t.d[i - 1][j];
    }
  }
}

// pairwise planar accelerations of q = (x_0..x_{n-1}, y_0..y_{n-1}):
// d^-3 as 1 / (d^2 sqrt(d^2)), the sum over j in index order from the
// first term, as the plain version takes them
__device__ void accel(const double* q, const double* m, int n, double G,
                      double* a) {
  for (int i = 0; i < n; ++i) {
    double sx = 0.0, sy = 0.0;
    for (int j = 0; j < n; ++j) {
      const double dx = q[j] - q[i];
      const double dy = q[n + j] - q[n + i];
      const double d2 = dx * dx + dy * dy;
      const double inv_d3 = d2 > 0.0 ? 1.0 / (d2 * sqrt(d2)) : 0.0;
      const double tx = m[j] * dx * inv_d3;
      const double ty = m[j] * dy * inv_d3;
      sx = j == 0 ? tx : sx + tx;
      sy = j == 0 ? ty : sy + ty;
    }
    a[i] = G * sx;
    a[n + i] = G * sy;
  }
}

__device__ __forceinline__ void add_cs(double& val, double& cs, double inc) {
  const double y = inc - cs;
  const double t = val + y;
  cs = (t - val) - y;
  val = t;
}

struct Call {
  const double* m;
  int n, nq;
  double G, epsilon;
  Tables tab;
};

// The per-body arrays of a call, each of nq = 2N values; a series (b, e,
// g) is 7 rows of ld values. For N <= MAX_BODIES they are the kernel's own
// arrays (ld = MAXQ), beyond it rows of the device workspace (ld = nq).
struct Arrays {
  double *q, *p, *csq, *csp, *q1, *p1, *csq1, *csp1, *a0;
  double *b, *e, *g;      // row j at j * ld
  double *xn, *at, *delta;
  int ld;
};
constexpr int N_VECTORS = 12;   // q .. a0, xn, at, delta
constexpr int N_SERIES = 3;     // b, e, g

// one corrector sweep over the 7 nodes; returns |db6|max / |a|max
__device__ double pc_sweep(const Call& c, const Arrays& w, double dt) {
  const int ld = w.ld;
  double *b = w.b, *g = w.g, *xn = w.xn, *at = w.at, *delta = w.delta;
  const double *x0 = w.q, *v0 = w.p, *a0 = w.a0;
  for (int n = 1; n < 8; ++n) {
    const double hn = H_NODES[n];
    for (int i = 0; i < c.nq; ++i) {
      double s = b[6 * ld + i] * 7.0 * hn / 9.0 + b[5 * ld + i];
      s = s * 3.0 * hn / 4.0 + b[4 * ld + i];
      s = s * 5.0 * hn / 7.0 + b[3 * ld + i];
      s = s * 2.0 * hn / 3.0 + b[2 * ld + i];
      s = s * 3.0 * hn / 5.0 + b[ld + i];
      s = s * hn / 2.0 + b[i];
      s = s * hn / 3.0 + a0[i];
      xn[i] = (s * dt * hn / 2.0 + v0[i]) * dt * hn + x0[i];
    }
    accel(xn, c.m, c.n, c.G, at);
    const int base = (n - 1) * n / 2;
    for (int i = 0; i < c.nq; ++i) {
      double val = (at[i] - a0[i]) / c.tab.rr[base];
      for (int k = 1; k < n; ++k)
        val = (val - g[(k - 1) * ld + i]) / c.tab.rr[base + k];
      delta[i] = val - g[(n - 1) * ld + i];
      g[(n - 1) * ld + i] = val;
      for (int j = 0; j < n - 1; ++j)
        b[j * ld + i] = b[j * ld + i] + delta[i] * c.tab.c[n - 1][j];
      b[(n - 1) * ld + i] = b[(n - 1) * ld + i] + delta[i];
    }
  }
  double db6 = 0.0, atm = 0.0;
  for (int i = 0; i < c.nq; ++i) {
    db6 = fmax(db6, fabs(delta[i]));
    atm = fmax(atm, fabs(at[i]));
  }
  return atm > 0.0 ? db6 / atm : 0.0;
}

// One trial step of size dt from (q, p, csq, csp) with the acceleration
// a0: b and e hold the predicted series on entry and the series predicted
// for dt_next on exit; the new state goes to (q1, p1, csq1, csp1).
// Returns whether the step is accepted.
__device__ bool step_trial(const Call& c, const Arrays& w, double dt,
                           double& dt_next) {
  const int nq = c.nq, n = c.n, ld = w.ld;
  double *b = w.b, *e = w.e, *g = w.g;
  for (int i = 0; i < 7; ++i)
    for (int k = 0; k < nq; ++k) {
      double s = 0.0;
      for (int j = i; j < 7; ++j) s = s + b[j * ld + k] * c.tab.d[j][i];
      g[i * ld + k] = s;
    }
  const double pc_tol = 0.45 * DBL_EPSILON;
  double err = DBL_MAX, err_last = DBL_MAX;
  for (int it = 0; err >= pc_tol && it < MAX_PC_ITER &&
                   (it <= 2 || err_last > err); ++it) {
    err_last = err;
    err = pc_sweep(c, w, dt);
  }

  const double dt2 = dt * dt;
  for (int i = 0; i < nq; ++i) {
    double x = w.q[i], cx = w.csq[i];
    for (int j = 6; j >= 0; --j) add_cs(x, cx, b[j * ld + i] / XW[j] * dt2);
    add_cs(x, cx, w.a0[i] / 2.0 * dt2);
    add_cs(x, cx, w.p[i] * dt);
    double v = w.p[i], cv = w.csp[i];
    for (int j = 6; j >= 0; --j) add_cs(v, cv, b[j * ld + i] / VW[j] * dt);
    add_cs(v, cv, w.a0[i] * dt);
    w.q1[i] = x;
    w.csq1[i] = cx;
    w.p1[i] = v;
    w.csp1[i] = cv;
  }

  // the error from the highest-order term over the bodies that move
  double* at = w.at;
  const double *q1 = w.q1, *p1 = w.p1;
  accel(q1, c.m, n, c.G, at);
  double maxak = 0.0, maxb6 = 0.0;
  for (int k = 0; k < n; ++k) {
    const double v2 = p1[k] * p1[k] + p1[n + k] * p1[n + k];
    const double x2 = q1[k] * q1[k] + q1[n + k] * q1[n + k];
    if (fabs(v2 * dt2 / (x2 > 0.0 ? x2 : 1.0)) >= 1e-16) {
      maxak = fmax(maxak, fmax(fabs(at[k]), fabs(at[n + k])));
      maxb6 = fmax(maxb6, fmax(fabs(b[6 * ld + k]), fabs(b[6 * ld + n + k])));
    }
  }
  const double e_rel = maxak > 0.0 ? maxb6 / maxak : 0.0;
  const double dt_new = (e_rel > 0.0 && isfinite(e_rel))
                            ? pow(c.epsilon / e_rel, 1.0 / 7.0) * dt
                            : dt / SAFETY;
  const bool accept = fabs(dt_new / dt) >= SAFETY;
  dt_next = accept ? fmin(dt_new, dt / SAFETY) : dt_new;

  // predict b and e to the next trial size; ratio^(j+1) by successive
  // products
  const double ratio = dt_next / dt;
  const bool wipe = ratio > 20.0;
  double powers[7];
  powers[0] = ratio;
  for (int j = 1; j < 7; ++j) powers[j] = powers[j - 1] * ratio;
  for (int k = 0; k < nq; ++k) {
    double be[7], en[7];
    for (int j = 0; j < 7; ++j) be[j] = b[j * ld + k] - e[j * ld + k];
    for (int j = 0; j < 7; ++j) {
      double s = 0.0;
      for (int l = 0; l < 7; ++l) s = s + PASCAL[j][l] * b[l * ld + k];
      en[j] = powers[j] * s;
    }
    for (int j = 0; j < 7; ++j) {
      e[j * ld + k] = wipe ? 0.0 : en[j];
      b[j * ld + k] = wipe ? 0.0 : en[j] + be[j];
    }
  }
  return accept;
}

__device__ void integrate(const Call& c, const Arrays& w, const double* x,
                          const double* y, const double* vx,
                          const double* vy, double dt, double* x_out,
                          double* y_out, double* vx_out, double* vy_out,
                          int* counts) {
  const int n = c.n, nq = c.nq, ld = w.ld;
  for (int k = 0; k < n; ++k) {
    w.q[k] = x[k];
    w.q[n + k] = y[k];
    w.p[k] = vx[k];
    w.p[n + k] = vy[k];
  }
  for (int i = 0; i < nq; ++i) {
    w.csq[i] = w.csp[i] = 0.0;
    for (int j = 0; j < 7; ++j) w.b[j * ld + i] = w.e[j * ld + i] = 0.0;
  }
  const double eps_t = 1e-14 * fabs(dt);
  double t = 0.0, dt_int = dt;
  int k = 0, accepted = 0;
  while (t < dt - eps_t && k < MAX_SUBSTEPS) {
    const double step_dt = fmin(dt_int, dt - t);
    accel(w.q, c.m, n, c.G, w.a0);
    double dt_next;
    const bool ok = step_trial(c, w, step_dt, dt_next);
    if (ok) {
      for (int i = 0; i < nq; ++i) {
        w.q[i] = w.q1[i];
        w.p[i] = w.p1[i];
        w.csq[i] = w.csq1[i];
        w.csp[i] = w.csp1[i];
      }
      t = t + step_dt;
      ++accepted;
    }
    dt_int = fmax(dt_next, 1e-12 * fabs(dt));
    ++k;
  }
  for (int i = 0; i < n; ++i) {
    x_out[i] = w.q[i];
    y_out[i] = w.q[n + i];
    vx_out[i] = w.p[i];
    vy_out[i] = w.p[n + i];
  }
  counts[0] = accepted;
  counts[1] = k;
}

// `work`: null for N <= MAX_BODIES (the arrays are the thread's own);
// beyond, (N_VECTORS + 7 N_SERIES) 2N float64 values of device memory
template <typename TDt>
__global__ void ias15_kernel(const double* __restrict__ x,
                             const double* __restrict__ y,
                             const double* __restrict__ vx,
                             const double* __restrict__ vy,
                             const double* __restrict__ m,
                             const TDt* __restrict__ dt_ptr, double G,
                             double epsilon, int n, double* x_out,
                             double* y_out, double* vx_out, double* vy_out,
                             int* counts, double* work) {
  Call c;
  c.m = m;
  c.n = n;
  c.nq = 2 * n;
  c.G = G;
  c.epsilon = epsilon;
  make_tables(c.tab);
  const double dt = (double)dt_ptr[0];
  if (work == nullptr) {
    double v[N_VECTORS][MAXQ], series[N_SERIES][7 * MAXQ];
    const Arrays w{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8],
                   series[0], series[1], series[2], v[9], v[10], v[11], MAXQ};
    integrate(c, w, x, y, vx, vy, dt, x_out, y_out, vx_out, vy_out, counts);
  } else {
    const int nq = c.nq;
    double* s = work + N_VECTORS * nq;
    const Arrays w{work, work + nq, work + 2 * nq, work + 3 * nq,
                   work + 4 * nq, work + 5 * nq, work + 6 * nq,
                   work + 7 * nq, work + 8 * nq, s, s + 7 * nq,
                   s + 14 * nq, work + 9 * nq, work + 10 * nq,
                   work + 11 * nq, nq};
    integrate(c, w, x, y, vx, vy, dt, x_out, y_out, vx_out, vy_out, counts);
  }
}

template <typename TDt>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  const int n = ip[0];
  double* work = (double*)p[11];
  if (n < 2 || (n > MAX_BODIES && work == nullptr))
    return (int)cudaErrorInvalidValue;
  ias15_kernel<TDt><<<1, 1, 0, (cudaStream_t)stream>>>(
      (const double*)p[0], (const double*)p[1], (const double*)p[2],
      (const double*)p[3], (const double*)p[4], (const TDt*)p[5], fp[0],
      fp[1], n, (double*)p[6], (double*)p[7], (double*)p[8], (double*)p[9],
      (int*)p[10], n > MAX_BODIES ? work : nullptr);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

// ptrs: x, y, vx, vy, mass (float64, N each), dt (one value of the run
//       type: the suffix), x_out, y_out, vx_out, vy_out, counts (int32:
//       accepted substeps, trial steps), work (float64, 66 N values for
//       N > 16; null up to 16 bodies)
// fp:   G, epsilon
// ip:   N (>= 2), 1
extern "C" {
int fc_ias15_f32(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_ias15_f64(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
