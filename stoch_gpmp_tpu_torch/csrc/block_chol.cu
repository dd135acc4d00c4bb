// C1: the block Cholesky factor of a symmetric block-tridiagonal precision
// and, on request, the dense inverse of that factor: the GP prior's build
// (BlockTridiag.cholesky, BlockTridiag.cholesky_inverse).
//
// Replaces no TPU kernel: the JAX package runs both recurrences as
// lax.scan (stoch_gpmp_tpu/gp/tridiag.py). Their plain PyTorch versions
// (gp/tridiag.py cholesky_loop, then dense_inv_transpose) are Python loops
// of T steps of small batched operations, ~2,790 device operations and
// their host launches for one planar prior.
//
// What it computes, per batch entry b, for diag [B, T, d, d] (B_t) and
// lower [B, T-1, d, d] (C_t, the block at (t, t-1)), d <= 16:
//   factor:  L_t = C_t D_{t-1}^{-T},  D_t D_t^T = B_t - L_t L_t^T
//            -> dout [B, T, d, d] (D_t, zeros above its diagonal) and
//               lout [B, T-1, d, d] (L_t);
//            a block that is not positive definite makes D_t all NaN, and
//            the NaN carries on through every later block;
//   inverse: X = L^{-1} [B, M, M] (M = T d) by block rows,
//            X_jj = D_j^{-1},  X_ij = A_i X_{i-1,j} with A_i = -D_i^{-1} L_i;
//            every entry above the diagonal is written as an exact 0.
// float32 or float64 in and out; the chain is carried in float64 in
// registers and shared memory, with no product below float64.
//
// Bound on the H100: latency. The factor is a chain of T dependent steps of
// d x d blocks (64 steps of 4 x 4 for a planar prior); the inverse writes
// M^2 elements (256 KB at M = 256) and does M T d^2 FMAs.
//
// Design (one launch, no synchronisation across CTAs):
// - grid (B, column groups): CTA (b, g) runs batch entry b's chain in its
//   warp 0, the factor warp: a step's d x d blocks are striped over the
//   lanes (entry i*d + j at lane (i*d + j) % 32), B_{t+1} and C_{t+1} are
//   loaded a step ahead, the Cholesky of the Schur complement runs in place
//   in shared memory column by column, and D_t^{-1} by forward substitution
//   with one lane per column. float64 square roots and divisions are long
//   instruction sequences and the chain waits on each: a pivot takes one
//   rsqrt, which gives both D_t[q][q] and its reciprocal, and the
//   substitution multiplies by the reciprocals. Only group 0 writes the
//   factor.
// - With the inverse, each further thread owns one of the group's kCols
//   columns of X and walks it down the block rows in step with the factor
//   warp: the factor warp writes D_t^{-1} and A_t into a two-slot ring, one
//   CTA barrier per step hands step t to the walkers, which then apply it
//   while the factor warp computes step t + 1. A walker keeps its column's
//   block X_{t,j} in registers; at each step the CTA stores d rows of its
//   kCols columns, coalesced by row.
// - The block sizes of the repo's robots are compiled in (d = 2: the per-dof
//   factor, 4: the planar robot, 14: the Panda); any other d up to 16 takes
//   the runtime-d instantiation (D = 0).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 16;   // the largest block size
constexpr int kCols = 128;  // columns of L^{-1} per CTA, one walker thread each

template <int DM>
struct Smem {
  double s[DM * DM];        // B_t - L_t L_t^T, factored in place into D_t
  double c[DM * DM];        // C_t
  double l[DM * DM];        // L_t
  double rd[DM];            // 1 / D_t[i][i]
  double dinv[2][DM * DM];  // D_t^{-1}, by the parity of t
  double a[2][DM * DM];     // A_t = -D_t^{-1} L_t, by the parity of t
};

__device__ __forceinline__ double nan64() { return __longlong_as_double(0x7ff8000000000000LL); }

template <int D, typename Real>
__global__ void __launch_bounds__(32 + kCols)
block_chol_kernel(const Real* __restrict__ diag, const Real* __restrict__ lower,
                  Real* __restrict__ dout, Real* __restrict__ lout, Real* __restrict__ linv,
                  int T, int d_rt) {
  constexpr int DM = D == 0 ? kMaxD : D;
  constexpr int EPL = (DM * DM + 31) / 32;  // block entries per lane of the factor warp
  const int d = D == 0 ? d_rt : D;
  const int dd = d * d;
  const long long M = (long long)T * d;
  __shared__ Smem<DM> sm;

  const long long b = blockIdx.x;
  const Real* bdiag = diag + b * T * dd;
  const Real* blower = lower + b * (T - 1) * dd;
  const bool walkers = linv != nullptr;
  const bool write_factor = blockIdx.y == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the factor warp's entries and the next step's inputs
  int ei[EPL], ej[EPL];
  bool ev[EPL];
  Real nb[EPL], nc[EPL];
#pragma unroll
  for (int k = 0; k < EPL; ++k) {
    const int e = lane + 32 * k;
    ev[k] = e < dd;
    ei[k] = e / d;
    ej[k] = e % d;
    nb[k] = warp == 0 && ev[k] ? bdiag[e] : Real(0);
    nc[k] = Real(0);
  }

  // the walker's column of X
  const long long col = (long long)blockIdx.y * kCols + (long long)threadIdx.x - 32;
  const bool walker = warp > 0 && col < M;
  const int cj = walker ? (int)(col / d) : 0, cr = walker ? (int)(col % d) : 0;
  Real* xcol = walker ? linv + b * M * M + col : nullptr;
  double x[DM];
#pragma unroll
  for (int q = 0; q < DM; ++q) x[q] = 0.0;

  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    if (warp == 0) {
      // stage B_t and C_t; load step t + 1's
#pragma unroll
      for (int k = 0; k < EPL; ++k) {
        const int e = lane + 32 * k;
        if (!ev[k]) continue;
        sm.s[e] = (double)nb[k];
        if (t > 0) sm.c[e] = (double)nc[k];
        if (t + 1 < T) {
          nb[k] = bdiag[(long long)(t + 1) * dd + e];
          nc[k] = blower[(long long)t * dd + e];
        }
      }
      __syncwarp();
      bool bad = false;
      if (t > 0) {
        const double* dp = sm.dinv[p ^ 1];
        // L_t = C_t D_{t-1}^{-T}: (i, j) = sum_{m <= j} C[i][m] Dinv[j][m]
#pragma unroll
        for (int k = 0; k < EPL; ++k) {
          if (!ev[k]) continue;
          double acc = 0.0;
#pragma unroll
          for (int m = 0; m < DM; ++m)
            if (m < d && m <= ej[k]) acc = fma(sm.c[ei[k] * d + m], dp[ej[k] * d + m], acc);
          sm.l[lane + 32 * k] = acc;
        }
        __syncwarp();
        // the Schur complement's lower triangle: B_t - L_t L_t^T
#pragma unroll
        for (int k = 0; k < EPL; ++k) {
          if (!ev[k] || ej[k] > ei[k]) continue;
          const int e = lane + 32 * k;
          double acc = sm.s[e];
#pragma unroll
          for (int m = 0; m < DM; ++m)
            if (m < d) acc = fma(-sm.l[ei[k] * d + m], sm.l[ej[k] * d + m], acc);
          sm.s[e] = acc;
        }
        __syncwarp();
      }
      // its Cholesky factor in place, column by column
#pragma unroll
      for (int q = 0; q < DM; ++q) {
        if (q >= d) continue;
        const double piv = sm.s[q * d + q];
        bad |= !(piv > 0.0);
        const double inv = rsqrt(piv);  // one rsqrt, no square root and division
        const double dq = piv * inv;
        __syncwarp();
        if (lane == 0) sm.rd[q] = inv;
#pragma unroll
        for (int k = 0; k < EPL; ++k) {
          if (!ev[k] || ej[k] != q || ei[k] < q) continue;
          const int e = lane + 32 * k;
          sm.s[e] = ei[k] == q ? dq : sm.s[e] * inv;
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < EPL; ++k) {
          if (!ev[k] || ej[k] <= q || ej[k] > ei[k]) continue;
          const int e = lane + 32 * k;
          sm.s[e] = fma(-sm.s[ei[k] * d + q], sm.s[ej[k] * d + q], sm.s[e]);
        }
        __syncwarp();
      }
      if (write_factor) {
#pragma unroll
        for (int k = 0; k < EPL; ++k) {
          if (!ev[k]) continue;
          const int e = lane + 32 * k;
          const double v = bad ? nan64() : (ej[k] <= ei[k] ? sm.s[e] : 0.0);
          dout[(b * T + t) * dd + e] = (Real)v;
          if (t > 0) lout[(b * (T - 1) + t - 1) * dd + e] = (Real)sm.l[e];
        }
      }
      // D_t^{-1} by forward substitution, lane j on column j, no division
      double* dv = sm.dinv[p];
      if (lane < d) {
        const int j = lane;
        double cv[DM];
#pragma unroll
        for (int i = 0; i < DM; ++i) {
          cv[i] = 0.0;
          if (i < d && i >= j) {
            double acc = i == j ? 1.0 : 0.0;
#pragma unroll
            for (int m = 0; m < i; ++m)
              if (m >= j) acc = fma(-sm.s[i * d + m], cv[m], acc);
            cv[i] = acc * sm.rd[i];
          }
        }
#pragma unroll
        for (int i = 0; i < DM; ++i)
          if (i < d) dv[i * d + j] = i < j ? 0.0 : (bad ? nan64() : cv[i]);
      }
      __syncwarp();
      if (t > 0 && walkers) {  // A_t = -D_t^{-1} L_t
#pragma unroll
        for (int k = 0; k < EPL; ++k) {
          if (!ev[k]) continue;
          double acc = 0.0;
#pragma unroll
          for (int m = 0; m < DM; ++m)
            if (m < d && m <= ei[k]) acc = fma(-dv[ei[k] * d + m], sm.l[m * d + ej[k]], acc);
          sm.a[p][lane + 32 * k] = acc;
        }
      }
      __syncwarp();
    }
    if (!walkers) continue;
    __syncthreads();  // step t's D^{-1} and A are in slot p
    if (walker) {
      if (t == cj) {
        const double* dv = sm.dinv[p];
#pragma unroll
        for (int q = 0; q < DM; ++q)
          if (q < d) x[q] = q < cr ? 0.0 : dv[q * d + cr];
      } else if (t > cj) {
        const double* at = sm.a[p];
        double y[DM];
#pragma unroll
        for (int q = 0; q < DM; ++q) {
          double acc = 0.0;
#pragma unroll
          for (int m = 0; m < DM; ++m)
            if (q < d && m < d) acc = fma(at[q * d + m], x[m], acc);
          y[q] = acc;
        }
#pragma unroll
        for (int q = 0; q < DM; ++q) x[q] = y[q];
      }
#pragma unroll
      for (int q = 0; q < DM; ++q)
        if (q < d) xcol[((long long)t * d + q) * M] = (Real)x[q];  // 0 above block row cj
    }
  }
}

template <typename Real>
cudaError_t launch(const void* diag, const void* lower, void* dout, void* lout, void* linv,
                   int T, int d, dim3 grid, dim3 block, cudaStream_t stream) {
  const Real* di = static_cast<const Real*>(diag);
  const Real* lo = static_cast<const Real*>(lower);
  Real* o1 = static_cast<Real*>(dout);
  Real* o2 = static_cast<Real*>(lout);
  Real* o3 = static_cast<Real*>(linv);
  switch (d) {
    case 2:
      block_chol_kernel<2, Real><<<grid, block, 0, stream>>>(di, lo, o1, o2, o3, T, d);
      break;
    case 4:
      block_chol_kernel<4, Real><<<grid, block, 0, stream>>>(di, lo, o1, o2, o3, T, d);
      break;
    case 14:
      block_chol_kernel<14, Real><<<grid, block, 0, stream>>>(di, lo, o1, o2, o3, T, d);
      break;
    default:
      block_chol_kernel<0, Real><<<grid, block, 0, stream>>>(di, lo, o1, o2, o3, T, d);
  }
  return cudaGetLastError();
}

}  // namespace

// diag [B, T, d, d] and lower [B, T-1, d, d] contiguous (lower may be null
// at T = 1); dout, lout: the factor's outputs of the same shapes (lout may
// be null at T = 1); linv [B, T d, T d] or null. Returns a cudaError_t.
extern "C" int block_chol_launch(const void* diag, const void* lower, void* dout, void* lout,
                                 void* linv, int B, int T, int d, int is_double, void* stream) {
  const long long m = (long long)T * d;
  const long long groups = linv == nullptr ? 1 : (m + kCols - 1) / kCols;
  if (B < 1 || T < 1 || d < 1 || d > kMaxD || groups > 65535 || (T > 1 && lower == nullptr) ||
      dout == nullptr || (T > 1 && lout == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)groups);
  const dim3 block(linv == nullptr ? 32 : 32 + kCols);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return (int)launch<double>(diag, lower, dout, lout, linv, T, d, grid, block, s);
  return (int)launch<float>(diag, lower, dout, lout, linv, T, d, grid, block, s);
}
