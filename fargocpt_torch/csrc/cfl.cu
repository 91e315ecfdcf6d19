// CFL time step on the GPU.
//
// Replaces the TPU kernel fargocpt_tpu/ops/pallas_kernels.py
// `cfl_pallas` / `_cfl_kernel` (reference src/cfl.cpp:185-382). Computes
// the whole CFL dt of fargocpt_torch/ops/cfl.py `condition_cfl`: the
// per-cell sum of squared inverse-dt terms (sound speed, radial and
// residual azimuthal motion, SN or tensor artificial viscosity, viscosity,
// heating/cooling), its max over rings 1..NR-2, and the FARGO shear limit
// between neighbouring rings i, i+1, i = 0..NR-3.
//
// Bound: device memory. Each cell reads sigma, energy, vrad (its two
// faces, the upper one the next ring's lower), vaz (its own and the next
// cell), Q+ and Q- once: six planes, 32 B a cell in f32, for ~60 flops.
// Design: one launch, one block of BLOCK threads a ring i = blockIdx.x,
// rings 0..NR-2 (ring NR-1 enters nothing), no index division:
//   1. the block reads ring i's vaz once, into shared memory, and sums it
//      thread-strided and then across the block: the ring mean;
//   2. rings 1..NR-2: the block evaluates its ring's cells with that mean
//      (vaz and the next cell's from shared memory) and reduces their max
//      of the squared inverse dt; it writes the mean and the max to
//      scratch (NR values each);
//   3. the last block to finish (a __threadfence, then an atomic counter
//      that this block sets back to 0, so no host memset is needed and the
//      launch can be captured in a CUDA graph) reduces the maxima of rings
//      1..NR-2 and the shear limit of the ring pairs, and writes
//      dt = min(shear, cfl / sqrt(max)).
// A ring longer than CFL_SMEM_BYTES of shared memory is read twice, the
// second time through L1/L2. The arithmetic is the plain version's,
// operation for operation (IEEE divisions, the per-cell square root, no
// fused multiply-add); max and min do not depend on the order, so dt does
// not depend on how the cells fall to blocks and threads. No value leaves
// the device; dt is a one-element device tensor.
#include "common.cuh"

namespace fc {
namespace {

struct CflParams {
  double gamma, alpha, const_nu, c2, lf, inv_hc_limit, cfl, dphi, invdphi;
  int adiabatic, sn, fast;
};

// a ring of vaz is kept in shared memory up to this size
constexpr int CFL_SMEM_BYTES = 40 * 1024;
// blocks a multiprocessor must hold (__launch_bounds__): the 1023 ring
// blocks of a 1024-ring grid fit in one wave of the 132 multiprocessors at
// 8, in 1.55 waves at the 5 that 48 registers a thread would give
constexpr int CFL_MIN_BLOCKS_F32 = 8;
constexpr int CFL_MIN_BLOCKS_F64 = 1;

// the maxima of rings 1..NR-2 and the shear limit of the ring pairs
// (i, i+1), i = 0..NR-3, from the scratch the ring blocks wrote, reduced by
// the last block; __ldcg reads them past this multiprocessor's L1
template <typename T>
__device__ void cfl_final(const T* partial, const T* vmean,
                          const T* __restrict__ cols, const CflParams& P,
                          int nr, T* __restrict__ out_dt) {
  T m = T(0);
  for (int k = 1 + threadIdx.x; k <= nr - 2; k += blockDim.x)
    m = nan_max(m, __ldcg(partial + k));
  m = block_reduce(m, MaxOp(), T(0));
  const T big = T(INFINITY);
  const T cfl_dphi = T(P.cfl * P.dphi);
  T s = big;
  for (int i = threadIdx.x; i < nr - 2; i += blockDim.x) {
    const T om0 = __ldcg(vmean + i) * col(cols, i, C_INV_RB);
    const T om1 = __ldcg(vmean + i + 1) * col(cols, i + 1, C_INV_RB);
    s = nan_min(s, cfl_dphi / (fabs(om0 - om1) + T(1e-100)));
  }
  s = block_reduce(s, MinOp(), big);
  if (threadIdx.x == 0) out_dt[0] = nan_min(s, T(P.cfl) / sqrt(m));
}

template <typename T, int MIN_BLOCKS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
cfl_ring_kernel(const T* __restrict__ sigma, const T* __restrict__ energy,
                const T* __restrict__ vrad, const T* __restrict__ vaz,
                const T* __restrict__ qplus, const T* __restrict__ qminus,
                const T* __restrict__ cols, CflParams P, int nr, int naz,
                int cached, T* vmean, T* partial,
                unsigned int* __restrict__ counter, T* __restrict__ out_dt) {
  extern __shared__ __align__(16) unsigned char cfl_smem[];
  T* ring = reinterpret_cast<T*>(cfl_smem);
  __shared__ T mean_sh;
  __shared__ bool last;
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)i * naz;
  const T* va_row = vaz + row;

  T s = T(0);
  for (int j = tid; j < naz; j += BLOCK) {
    const T v = va_row[j];
    if (cached) ring[j] = v;
    s += v;
  }
  s = block_reduce(s, SumOp(), T(0));   // its barriers publish `ring`
  if (tid == 0) mean_sh = s / T(naz);
  __syncthreads();
  const T vm = mean_sh;
  const T* va_src = cached ? ring : va_row;

  if (i >= 1) {
    const T gg1 = T(P.gamma * (P.gamma - 1.0));
    const T sqrt_g = T(sqrt(P.gamma));
    const T lf = T(P.lf);
    const T four_c2 = T(4.0 * P.c2);
    const T inv_cell = col(cols, i, C_INV_CELL);
    const T inv_dxrad = col(cols, i, C_INV_DXRAD);
    const T inv_dxaz = col(cols, i, C_INV_DXAZ);
    const T omega_k = col(cols, i, C_OMEGA_K);
    const T cs_iso = col(cols, i, C_CS_ISO);
    const T inv_rb = col(cols, i, C_INV_RB);
    const T inv_diff_rsup = col(cols, i, C_INV_DIFF_RSUP);
    T m = T(0);
    for (int j = tid; j < naz; j += BLOCK) {
      const size_t c = row + j;
      const T sig = sigma[c];
      const T va = va_src[j];
      const T van = va_src[jnext(j, naz)];
      const T vr0 = vrad[c];
      const T vr1 = vrad[c + naz];
      T cs, nu;
      if (P.adiabatic) {
        cs = sqrt(gg1 * energy[c] / sig);
        const T h = cs / sqrt_g / omega_k;
        nu = P.alpha > 0.0 ? T(P.alpha) * cs * h : T(P.const_nu);
      } else {
        cs = cs_iso;
        const T h = cs / omega_k;
        nu = P.alpha > 0.0 ? T(P.alpha) * cs * h : T(P.const_nu);
      }
      const T vres = P.fast ? va - vm : va;
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
        const T eps_rr = dv_r * inv_diff_rsup;
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
    if (tid == 0) partial[i] = m;
  }
  if (tid == 0) {
    vmean[i] = vm;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  cfl_final(partial, vmean, cols, P, nr, out_dt);
  if (tid == 0) *counter = 0u;
}

template <typename T, int MIN_BLOCKS>
int launch(void* const* p, const double* fp, const int* ip, void* stream) {
  CflParams P{fp[0], fp[1], fp[2], fp[3], fp[4], fp[5], fp[6], fp[7], fp[8],
              ip[2], ip[3], ip[4]};
  const int nr = ip[0], naz = ip[1];
  const size_t ring_bytes = (size_t)naz * sizeof(T);
  const int cached = ring_bytes <= (size_t)CFL_SMEM_BYTES;
  T* scratch = (T*)p[7];   // (2 NR): the ring means, then the ring maxima
  cfl_ring_kernel<T, MIN_BLOCKS><<<nr - 1, BLOCK, cached ? ring_bytes : 0,
                       (cudaStream_t)stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], P, nr, naz, cached,
      scratch, scratch + nr, (unsigned int*)p[8], (T*)p[9]);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fc

// ptrs: sigma, energy, vrad, vaz, qplus, qminus, cols, scratch (2 NR),
//       counter (1, int32, 0 between calls), out (1)
// fp:   gamma, alpha, constant nu, C^2, leapfrog factor, 1 / heating-cooling
//       limit, cfl, dphi, 1 / dphi
// ip:   NR (>= 3), NAZ, adiabatic, SN artificial viscosity, fast transport
extern "C" {
int fc_cfl_f32(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<float, fc::CFL_MIN_BLOCKS_F32>(p, fp, ip, s);
}
int fc_cfl_f64(void* const* p, const double* fp, const int* ip, void* s) {
  return fc::launch<double, fc::CFL_MIN_BLOCKS_F64>(p, fp, ip, s);
}
const char* fc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
}
