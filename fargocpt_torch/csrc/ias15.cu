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
// thread (N <= 16 bodies) runs the whole call, its substeps, its corrector
// iterations and the step-size control, in registers and local memory, and
// never returns to the host. The arithmetic follows the plain version
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

// one corrector sweep over the 7 nodes; returns |db6|max / |a|max
__device__ double pc_sweep(const Call& c, const double* x0, const double* v0,
                           const double* a0, double (*b)[MAXQ],
                           double (*g)[MAXQ], double dt) {
  double xn[MAXQ], at[MAXQ], delta[MAXQ];
  for (int n = 1; n < 8; ++n) {
    const double hn = H_NODES[n];
    for (int i = 0; i < c.nq; ++i) {
      double s = b[6][i] * 7.0 * hn / 9.0 + b[5][i];
      s = s * 3.0 * hn / 4.0 + b[4][i];
      s = s * 5.0 * hn / 7.0 + b[3][i];
      s = s * 2.0 * hn / 3.0 + b[2][i];
      s = s * 3.0 * hn / 5.0 + b[1][i];
      s = s * hn / 2.0 + b[0][i];
      s = s * hn / 3.0 + a0[i];
      xn[i] = (s * dt * hn / 2.0 + v0[i]) * dt * hn + x0[i];
    }
    accel(xn, c.m, c.n, c.G, at);
    const int base = (n - 1) * n / 2;
    for (int i = 0; i < c.nq; ++i) {
      double val = (at[i] - a0[i]) / c.tab.rr[base];
      for (int k = 1; k < n; ++k)
        val = (val - g[k - 1][i]) / c.tab.rr[base + k];
      delta[i] = val - g[n - 1][i];
      g[n - 1][i] = val;
      for (int j = 0; j < n - 1; ++j)
        b[j][i] = b[j][i] + delta[i] * c.tab.c[n - 1][j];
      b[n - 1][i] = b[n - 1][i] + delta[i];
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
__device__ bool step_trial(const Call& c, const double* q, const double* p,
                           const double* csq, const double* csp,
                           const double* a0, double (*b)[MAXQ],
                           double (*e)[MAXQ], double dt, double* q1,
                           double* p1, double* csq1, double* csp1,
                           double& dt_next) {
  const int nq = c.nq, n = c.n;
  double g[7][MAXQ];
  for (int i = 0; i < 7; ++i)
    for (int k = 0; k < nq; ++k) {
      double s = 0.0;
      for (int j = i; j < 7; ++j) s = s + b[j][k] * c.tab.d[j][i];
      g[i][k] = s;
    }
  const double pc_tol = 0.45 * DBL_EPSILON;
  double err = DBL_MAX, err_last = DBL_MAX;
  for (int it = 0; err >= pc_tol && it < MAX_PC_ITER &&
                   (it <= 2 || err_last > err); ++it) {
    err_last = err;
    err = pc_sweep(c, q, p, a0, b, g, dt);
  }

  const double dt2 = dt * dt;
  for (int i = 0; i < nq; ++i) {
    double x = q[i], cx = csq[i];
    for (int j = 6; j >= 0; --j) add_cs(x, cx, b[j][i] / XW[j] * dt2);
    add_cs(x, cx, a0[i] / 2.0 * dt2);
    add_cs(x, cx, p[i] * dt);
    double v = p[i], cv = csp[i];
    for (int j = 6; j >= 0; --j) add_cs(v, cv, b[j][i] / VW[j] * dt);
    add_cs(v, cv, a0[i] * dt);
    q1[i] = x;
    csq1[i] = cx;
    p1[i] = v;
    csp1[i] = cv;
  }

  // the error from the highest-order term over the bodies that move
  double at[MAXQ];
  accel(q1, c.m, n, c.G, at);
  double maxak = 0.0, maxb6 = 0.0;
  for (int k = 0; k < n; ++k) {
    const double v2 = p1[k] * p1[k] + p1[n + k] * p1[n + k];
    const double x2 = q1[k] * q1[k] + q1[n + k] * q1[n + k];
    if (fabs(v2 * dt2 / (x2 > 0.0 ? x2 : 1.0)) >= 1e-16) {
      maxak = fmax(maxak, fmax(fabs(at[k]), fabs(at[n + k])));
      maxb6 = fmax(maxb6, fmax(fabs(b[6][k]), fabs(b[6][n + k])));
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
    for (int j = 0; j < 7; ++j) be[j] = b[j][k] - e[j][k];
    for (int j = 0; j < 7; ++j) {
      double s = 0.0;
      for (int l = 0; l < 7; ++l) s = s + PASCAL[j][l] * b[l][k];
      en[j] = powers[j] * s;
    }
    for (int j = 0; j < 7; ++j) {
      e[j][k] = wipe ? 0.0 : en[j];
      b[j][k] = wipe ? 0.0 : en[j] + be[j];
    }
  }
  return accept;
}

template <typename TDt>
__global__ void ias15_kernel(const double* __restrict__ x,
                             const double* __restrict__ y,
                             const double* __restrict__ vx,
                             const double* __restrict__ vy,
                             const double* __restrict__ m,
                             const TDt* __restrict__ dt_ptr, double G,
                             double epsilon, int n, double* x_out,
                             double* y_out, double* vx_out, double* vy_out,
                             int* counts) {
  Call c;
  c.m = m;
  c.n = n;
  c.nq = 2 * n;
  c.G = G;
  c.epsilon = epsilon;
  make_tables(c.tab);
  double q[MAXQ], p[MAXQ], csq[MAXQ], csp[MAXQ];
  double q1[MAXQ], p1[MAXQ], csq1[MAXQ], csp1[MAXQ], a0[MAXQ];
  double b[7][MAXQ], e[7][MAXQ];
  for (int k = 0; k < n; ++k) {
    q[k] = x[k];
    q[n + k] = y[k];
    p[k] = vx[k];
    p[n + k] = vy[k];
  }
  for (int i = 0; i < c.nq; ++i) {
    csq[i] = csp[i] = 0.0;
    for (int j = 0; j < 7; ++j) b[j][i] = e[j][i] = 0.0;
  }
  const double dt = (double)dt_ptr[0];
  const double eps_t = 1e-14 * fabs(dt);
  double t = 0.0, dt_int = dt;
  int k = 0, accepted = 0;
  while (t < dt - eps_t && k < MAX_SUBSTEPS) {
    const double step_dt = fmin(dt_int, dt - t);
    accel(q, m, n, G, a0);
    double dt_next;
    const bool ok = step_trial(c, q, p, csq, csp, a0, b, e, step_dt, q1, p1,
                               csq1, csp1, dt_next);
    if (ok) {
      for (int i = 0; i < c.nq; ++i) {
        q[i] = q1[i];
        p[i] = p1[i];
        csq[i] = csq1[i];
        csp[i] = csp1[i];
      }
      t = t + step_dt;
      ++accepted;
    }
    dt_int = fmax(dt_next, 1e-12 * fabs(dt));
    ++k;
  }
  for (int i = 0; i < n; ++i) {
    x_out[i] = q[i];
    y_out[i] = q[n + i];
    vx_out[i] = p[i];
    vy_out[i] = p[n + i];
  }
  counts[0] = accepted;
  counts[1] = k;
}

template <typename TDt>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  const int n = ip[0];
  if (n < 2 || n > MAX_BODIES) return (int)cudaErrorInvalidValue;
  ias15_kernel<TDt><<<1, 1, 0, (cudaStream_t)stream>>>(
      (const double*)p[0], (const double*)p[1], (const double*)p[2],
      (const double*)p[3], (const double*)p[4], (const TDt*)p[5], fp[0],
      fp[1], n, (double*)p[6], (double*)p[7], (double*)p[8], (double*)p[9],
      (int*)p[10]);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

// ptrs: x, y, vx, vy, mass (float64, N each), dt (one value of the run
//       type: the suffix), x_out, y_out, vx_out, vy_out, counts (int32:
//       accepted substeps, trial steps)
// fp:   G, epsilon
// ip:   N (2..16), 1
extern "C" {
int fc_ias15_f32(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<float>(p, fp, ip, s);
}
int fc_ias15_f64(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<double>(p, fp, ip, s);
}
}
