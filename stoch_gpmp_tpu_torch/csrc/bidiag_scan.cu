// S1: block-bidiagonal substitution on planes, the long-horizon sampler's
// solve (ParallelBidiagSolver.solve_L_planes / solve_LT_planes).
//
// Replaces no TPU kernel: the JAX package runs this solve as XLA's
// associative_scan (stoch_gpmp_tpu/gp/tridiag.py:259 _affine_assoc_scan).
// Its plain PyTorch version (ops/kernels/bidiag_scan.py bidiag_scan_plain)
// is that log-step scan, some log2(T) (d^3 + d^2) elementwise plane
// operations per solve, each a launch.
//
// What it computes, per batch row b and for d planes [B, T]:
//   forward  L y = x:   y_t = A_t y_{t-1} + D_t^{-1} x_t   (A_0 = 0)
//   backward L^T y = x: y_t = A_t y_{t+1} + D_t^{-T} x_t   (A_{T-1} = 0)
// with dinv = D_t^{-1} [T, d, d] lower triangular and A [T, d, d] the
// transition of that direction, float32 or float64, d even up to 16. The
// block sizes of the repo's robots are compiled in (d = 4: the planar robot,
// d = 14: the Panda); any other even d takes the runtime-d instantiation
// (D = 0), which keeps its vectors in local memory.
//
// Bound on the H100: bytes. A solve reads and writes the planes once (at
// T = 4096, B = 480, d = 4, float32: 62.9 MB, 18.8 us at 3.35 TB/s) and
// does ~2.5 d^2 FMAs per (b, t). The tables do not depend on b, so a CTA
// that holds several rows reads them once for all of them.
//
// Design (one launch, no synchronisation across CTAs):
// - A CTA holds `rows` batch rows and walks time in segments of `chunks`
//   chunks of kChunk steps (backward: from the last segment to the first).
//   A segment's planes are staged in shared memory with coalesced loads
//   (16-byte vectors where the time stride is 1 and the rows aligned), one
//   padding word per chunk so that threads walking different chunks hit
//   different banks.
// - Phase 1: thread (row r, chunk k) runs its chunk's recurrence from a
//   zero carry and keeps the local result in shared memory. The tables of
//   each step, for all the segment's chunks, stream through a ring of
//   kStages buffers in shared memory by cp.async, kStages - 1 steps ahead:
//   read from device memory step by step, each step's table latency would
//   stall every thread (~840 cycles a step in the first design).
// - Phase 2: one thread per row carries the segment's carry across its
//   chunks in order: carry = local_end(k) + Psi_k carry, Psi_k the chunk's
//   whole transition (the phi table at the chunk's last step, forward, or
//   first step, backward).
// - Phase 3: y_t = local_t + phi_t carry_in(k), where phi_t, the product of
//   the transitions from the chunk's start to t, comes from a table built
//   once per factor (ops/kernels/bidiag_scan.py chunk_prefix), through the
//   same ring; then the segment is written back coalesced.
// The threads of a warp that walk the same chunk of different rows (rows
// fastest) read the same ring entries, so the rows of a CTA share each
// table copy.
// - The launcher picks the shape: the most rows per CTA (up to 8) that still
//   launch nine tenths of the SMs' worth of CTAs, then the most chunks a
//   segment holds within kMaxThreads threads and the shared memory of a CTA
//   (choose_shape). bidiag_scan_launch_shaped takes a given shape, to sweep.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;        // steps per thread (the phi tables' chunk)
constexpr int kMaxThreads = 256;  // rows * chunks per CTA
constexpr int kSmemLimit = 232448;
constexpr int kUnroll = 16;       // staging loads a thread keeps in flight
constexpr int kStages = 4;        // table ring buffers
constexpr int kMaxD = 16;         // the largest block size (the runtime-d vectors)

struct Strides {  // in elements
  long long plane, batch, time;
};

template <typename F>
struct VecOf;
template <>
struct VecOf<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct VecOf<double> {
  using type = double2;
  static constexpr int n = 2;
};

// A row's stride in shared memory: d padded planes, then padded so that the
// rows of a CTA start on banks 128 / (elem * rows) words apart (a warp in
// phases 1 and 3 spans rows x chunks).
__host__ __device__ inline int row_stride(int d, int chunks, int rows, int elem) {
  const int words = 128 / elem, row = d * chunks * (kChunk + 1);
  if (rows == 1) return row;
  return row + (((words / rows - row) % words) + words) % words;
}

// Bytes of the CTA's shared memory before the table ring (16-byte aligned).
__host__ __device__ inline size_t ring_offset(int d, int chunks, int rows, int elem) {
  const size_t b = (size_t)elem * ((size_t)rows * row_stride(d, chunks, rows, elem) +
                                   (size_t)chunks * d * d + (size_t)rows * chunks * d +
                                   (size_t)rows * d);
  return (b + 15) / 16 * 16;
}

// The ring's chunk stride: two [d, d] matrices (dinv and A in phase 1, phi
// alone in phase 3) and 16 bytes of padding, so that the threads of a warp
// (8 chunks) read 16-byte vectors from distinct banks.
__host__ __device__ inline int ring_chunk(int d, int elem) { return 2 * d * d + 16 / elem; }

__host__ __device__ inline size_t smem_layout(int d, int chunks, int rows, int elem) {
  return ring_offset(d, chunks, rows, elem) +
         (size_t)elem * kStages * chunks * ring_chunk(d, elem);
}

// A [D, D] matrix in shared memory: up to D = 8 the whole matrix in
// registers by 16-byte loads, above it (and at a runtime d, D = 0) entry by
// entry as the arithmetic reaches it.
template <typename F, int D>
struct RegMat {
  F v[D * D];
  __device__ __forceinline__ F operator()(int e) const { return v[e]; }
};

template <typename F>
struct PtrMat {
  const F* p;
  __device__ __forceinline__ F operator()(int e) const { return p[e]; }
};

template <typename F, int D>
__device__ __forceinline__ auto smem_mat(const F* p) {
  if constexpr (D != 0 && D <= 8) {
    using VT = typename VecOf<F>::type;
    constexpr int V = VecOf<F>::n;
    RegMat<F, D> m;
#pragma unroll
    for (int q = 0; q < D * D / V; ++q) {
      const VT w = reinterpret_cast<const VT*>(p)[q];
      const F* wf = reinterpret_cast<const F*>(&w);
#pragma unroll
      for (int e = 0; e < V; ++e) m.v[q * V + e] = wf[e];
    }
    return m;
  } else {
    return PtrMat<F>{p};
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Walks the steps of the segment's chunks in the threads' order (step jj of
// a chunk of n steps is t = its start + jj, or + n - 1 - jj backward): the NM
// tables' matrices of step jj of every chunk are copied into ring buffer jj
// % kStages by cp.async, kStages - 1 steps ahead of the step the threads
// compute, so that no thread waits on the tables' latency; body(jj, mats)
// then runs for the thread's chunk (when `active`), mats its NM matrices.
// Every thread of the CTA calls it. d_rt: the block size when D = 0.
template <typename F, int D, int NM, bool kBack, typename Body>
__device__ __forceinline__ void ring_walk(F* ring, int d_rt, int chunks,
                                          const F* __restrict__ tab0,
                                          const F* __restrict__ tab1, int t0, int len, int nch,
                                          int k, bool active, Body body) {
  constexpr int V = VecOf<F>::n;
  const int d = D ? D : d_rt, dd = d * d, per = NM * dd / V;
  const int cs = ring_chunk(d, (int)sizeof(F)), steps = min(kChunk, len);
  auto prefetch = [&](int jj) {
    F* st = ring + (jj % kStages) * chunks * cs;
    for (int e = threadIdx.x; e < nch * per; e += blockDim.x) {
      const int kc = e / per, q = e - kc * per;
      const int nk = min(kChunk, len - kc * kChunk);
      if (jj >= nk) continue;
      const int t = t0 + kc * kChunk + (kBack ? nk - 1 - jj : jj);
      const int m = q / (dd / V), qq = q - m * (dd / V);
      cp_async16(st + kc * cs + m * dd + qq * V,
                 (m == 0 ? tab0 : tab1) + (size_t)t * dd + qq * V);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) prefetch(s);
    cp_async_commit();
  }
  for (int jj = 0; jj < steps; ++jj) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step jj has landed; every thread is done with step jj - 1
    if (jj + kStages - 1 < steps) prefetch(jj + kStages - 1);
    cp_async_commit();
    if (active) body(jj, ring + (jj % kStages) * chunks * cs + k * cs);
  }
  cp_async_wait<0>();
}

// Position of step s of a segment in a padded plane.
__device__ __forceinline__ int pad_pos(int s) { return s + s / kChunk; }

// Moves the segment [t0, t0 + len) of the CTA's rows between the planes in
// device memory and shared memory, V elements per access (V = 1: any
// strides). kIn: device to shared, else shared to device. d_rt: the block
// size when D = 0.
template <typename F, int D, int V, bool kIn>
__device__ __forceinline__ void stage(const F* __restrict__ in, F* __restrict__ out, Strides g,
                                      F* sm, int d_rt, int row_stride, int plane, int b0, int B,
                                      int rows, int t0, int len) {
  using VT = typename VecOf<F>::type;
  const int d = D ? D : d_rt;
  const int nv = (len + V - 1) / V, total = rows * d;
  const int nt = blockDim.x;
  // (ri, v): row-plane ri = r * D + i and access v, advanced by nt per step
  int ri = threadIdx.x / nv, v = threadIdx.x - ri * nv;
  const int dri = nt / nv, dv = nt - dri * nv;
  while (ri < total) {
    F val[kUnroll][V];
    int pri[kUnroll], pv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      pri[u] = ri;
      pv[u] = v;
      const int r = ri / d, i = ri - r * d, b = b0 + r;
      if (ri < total && b < B) {
        const int t = t0 + v * V;
        if constexpr (kIn) {
          const F* p = in + (long long)b * g.batch + (long long)i * g.plane + (long long)t * g.time;
          if (V > 1 && t + V <= t0 + len) {
            const VT w = __ldg(reinterpret_cast<const VT*>(p));
            const F* wf = reinterpret_cast<const F*>(&w);
#pragma unroll
            for (int q = 0; q < V; ++q) val[u][q] = wf[q];
          } else {
#pragma unroll
            for (int q = 0; q < V; ++q) val[u][q] = t + q < t0 + len ? __ldg(p + q * g.time) : F(0);
          }
        } else {
          const F* s = sm + r * row_stride + i * plane;
#pragma unroll
          for (int q = 0; q < V; ++q) {
            const int sl = t - t0 + q;
            val[u][q] = sl < len ? s[pad_pos(sl)] : F(0);
          }
        }
      }
      v += dv;
      ri += dri;
      if (v >= nv) {
        v -= nv;
        ++ri;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = pri[u] / d, i = pri[u] - r * d, b = b0 + r;
      if (pri[u] >= total || b >= B) continue;
      const int t = t0 + pv[u] * V;
      if constexpr (kIn) {
        F* s = sm + r * row_stride + i * plane;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int sl = t - t0 + q;
          if (sl < len) s[pad_pos(sl)] = val[u][q];
        }
      } else {
        F* p = out + (long long)b * g.batch + (long long)i * g.plane + (long long)t * g.time;
        if (V > 1 && t + V <= t0 + len) {
          VT w;
          F* wf = reinterpret_cast<F*>(&w);
#pragma unroll
          for (int q = 0; q < V; ++q) wf[q] = val[u][q];
          *reinterpret_cast<VT*>(p) = w;
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q)
            if (t + q < t0 + len) p[q * g.time] = val[u][q];
        }
      }
    }
  }
}

template <typename F, int D, bool kBack>
__global__ void __launch_bounds__(kMaxThreads)
    bidiag_scan_kernel(const F* __restrict__ x, Strides gx, F* __restrict__ y, Strides gy,
                       const F* __restrict__ dinv, const F* __restrict__ a,
                       const F* __restrict__ phi, int B, int T, int d_rt, int rows, int chunks,
                       bool vx, bool vy) {
  constexpr int V = VecOf<F>::n;
  constexpr int DA = D ? D : kMaxD;  // the vectors' length
  const int d = D ? D : d_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F* sm = reinterpret_cast<F*>(smem_raw);
  const int plane = chunks * (kChunk + 1);
  const int rs = row_stride(d, chunks, rows, (int)sizeof(F));
  F* psi = sm + rows * rs;              // [chunks][d][d] chunk transitions
  F* cin = psi + chunks * d * d;        // [rows][chunks][d] carry into each chunk
  F* carry = cin + rows * chunks * d;   // [rows][d] carry into the segment
  F* ring = reinterpret_cast<F*>(smem_raw + ring_offset(d, chunks, rows, (int)sizeof(F)));
  const int tid = threadIdx.x;
  const int r = tid % rows, k = tid / rows;
  const int b0 = blockIdx.x * rows;
  const bool row_ok = b0 + r < B;
  const int seg_len = chunks * kChunk, nseg = (T + seg_len - 1) / seg_len;
  for (int i = tid; i < rows * d; i += blockDim.x) carry[i] = F(0);

  for (int q = 0; q < nseg; ++q) {
    const int seg = kBack ? nseg - 1 - q : q;
    const int t0 = seg * seg_len, len = min(seg_len, T - t0);
    const int nch = (len + kChunk - 1) / kChunk;
    __syncthreads();  // the previous segment is written back, its carry set
    if (vx)
      stage<F, D, V, true>(x, nullptr, gx, sm, d, rs, plane, b0, B, rows, t0, len);
    else
      stage<F, D, 1, true>(x, nullptr, gx, sm, d, rs, plane, b0, B, rows, t0, len);
    __syncthreads();

    // phase 1: the chunk's recurrence from a zero carry
    const int kt0 = t0 + k * kChunk, n = min(kChunk, len - k * kChunk);
    const bool active = k < nch && row_ok;
    F* mine = sm + r * rs + k * (kChunk + 1);
    F loc[DA];
#pragma unroll
    for (int i = 0; i < d; ++i) loc[i] = F(0);
    ring_walk<F, D, 2, kBack>(ring, d, chunks, dinv, a, t0, len, nch, k, active,
                              [&](int jj, const F* mats) {
      if (jj >= n) return;
      const int j = kBack ? n - 1 - jj : jj;
      const auto m = smem_mat<F, D>(mats);
      const auto at = smem_mat<F, D>(mats + d * d);
      F xv[DA], nl[DA];
#pragma unroll
      for (int i = 0; i < d; ++i) xv[i] = mine[i * plane + j];
#pragma unroll
      for (int i = 0; i < d; ++i) {
        F c = F(0);
#pragma unroll
        for (int jx = 0; jx < d; ++jx) {
          if (kBack ? jx < i : jx > i) continue;  // the triangle of zeros
          c = fma(m(kBack ? jx * d + i : i * d + jx), xv[jx], c);
        }
#pragma unroll
        for (int jx = 0; jx < d; ++jx) c = fma(at(i * d + jx), loc[jx], c);
        nl[i] = c;
      }
#pragma unroll
      for (int i = 0; i < d; ++i) {
        loc[i] = nl[i];
        mine[i * plane + j] = nl[i];
      }
    });
    if (active && r == 0) {
      const F* p = phi + (size_t)(kBack ? kt0 : kt0 + n - 1) * d * d;
#pragma unroll
      for (int e = 0; e < d * d; ++e) psi[k * d * d + e] = __ldg(p + e);
    }
    __syncthreads();

    // phase 2: the carries across the segment's chunks, one thread per row
    if (tid < rows && b0 + tid < B) {
      F cy[DA];
#pragma unroll
      for (int i = 0; i < d; ++i) cy[i] = carry[tid * d + i];
#pragma unroll 4
      for (int kk = 0; kk < nch; ++kk) {
        const int kc = kBack ? nch - 1 - kk : kk;
        F* cd = cin + (tid * chunks + kc) * d;
        const int nc = min(kChunk, len - kc * kChunk);
        const F* le = sm + tid * rs + kc * (kChunk + 1) + (kBack ? 0 : nc - 1);
        const F* ps = psi + kc * d * d;
        F nx[DA];
#pragma unroll
        for (int i = 0; i < d; ++i) {
          cd[i] = cy[i];
          F c = le[i * plane];
#pragma unroll
          for (int jx = 0; jx < d; ++jx) c = fma(ps[i * d + jx], cy[jx], c);
          nx[i] = c;
        }
#pragma unroll
        for (int i = 0; i < d; ++i) cy[i] = nx[i];
      }
#pragma unroll
      for (int i = 0; i < d; ++i) carry[tid * d + i] = cy[i];
    }
    __syncthreads();

    // phase 3: y_t = local_t + phi_t carry_in
    F ci[DA];
#pragma unroll
    for (int i = 0; i < d; ++i) ci[i] = active ? cin[(r * chunks + k) * d + i] : F(0);
    ring_walk<F, D, 1, kBack>(ring, d, chunks, phi, phi, t0, len, nch, k, active,
                              [&](int jj, const F* mats) {
      if (jj >= n) return;
      const int j = kBack ? n - 1 - jj : jj;
      const auto p = smem_mat<F, D>(mats);
      F out[DA];
#pragma unroll
      for (int i = 0; i < d; ++i) {
        F c = mine[i * plane + j];
#pragma unroll
        for (int jx = 0; jx < d; ++jx) c = fma(p(i * d + jx), ci[jx], c);
        out[i] = c;
      }
#pragma unroll
      for (int i = 0; i < d; ++i) mine[i * plane + j] = out[i];
    });
    __syncthreads();
    if (vy)
      stage<F, D, V, false>(nullptr, y, gy, sm, d, rs, plane, b0, B, rows, t0, len);
    else
      stage<F, D, 1, false>(nullptr, y, gy, sm, d, rs, plane, b0, B, rows, t0, len);
  }
}

// Whether V-element vectors along time are aligned for every row and plane.
template <typename F>
bool vectorizable(const void* p, Strides g, int B, int d) {
  constexpr int V = VecOf<F>::n;
  return g.time == 1 && (B == 1 || g.batch % V == 0) && (d == 1 || g.plane % V == 0) &&
         reinterpret_cast<uintptr_t>(p) % (V * sizeof(F)) == 0;
}

template <typename F, int D, bool kBack>
int launch(const void* x, Strides gx, void* y, Strides gy, const void* dinv, const void* a,
           const void* phi, int B, int T, int d, int rows, int chunks, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  auto kernel = bidiag_scan_kernel<F, D, kBack>;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kernel<<<(B + rows - 1) / rows, rows * chunks, smem_layout(d, chunks, rows, (int)sizeof(F)),
           stream>>>(static_cast<const F*>(x), gx, static_cast<F*>(y), gy,
                     static_cast<const F*>(dinv), static_cast<const F*>(a),
                     static_cast<const F*>(phi), B, T, d, rows, chunks,
                     vectorizable<F>(x, gx, B, d), vectorizable<F>(y, gy, B, d));
  return (int)cudaGetLastError();
}

// d = 4 and 14 compiled in, any other even d up to kMaxD at runtime (D = 0).
template <typename F, bool kBack>
int dispatch(int d, const void* x, Strides gx, void* y, Strides gy, const void* dinv,
             const void* a, const void* phi, int B, int T, int rows, int chunks,
             cudaStream_t s) {
  switch (d) {
    case 4: return launch<F, 4, kBack>(x, gx, y, gy, dinv, a, phi, B, T, d, rows, chunks, s);
    case 14: return launch<F, 14, kBack>(x, gx, y, gy, dinv, a, phi, B, T, d, rows, chunks, s);
    default: return launch<F, 0, kBack>(x, gx, y, gy, dinv, a, phi, B, T, d, rows, chunks, s);
  }
}

// Whether (rows, chunks) is a shape the kernel takes at block size d.
bool shape_ok(int rows, int chunks, int d, int elem) {
  return (rows == 1 || rows == 2 || rows == 4 || rows == 8) && chunks >= 1 &&
         rows * chunks <= kMaxThreads &&
         smem_layout(d, chunks, rows, elem) <= (size_t)kSmemLimit;
}

// The launch shape for B rows of T steps on the current device (see the
// design above); rows = 0 when none fits.
void choose_shape(int B, int T, int d, int elem, int* rows, int* chunks) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  int r = 1;
  for (int c = 8; c > 1; c /= 2)
    if ((B + c - 1) / c >= sms * 9 / 10) {
      r = c;
      break;
    }
  int ch = min((T + kChunk - 1) / kChunk, kMaxThreads / r);
  while (ch > 1 && smem_layout(d, ch, r, elem) > (size_t)kSmemLimit) --ch;
  *rows = shape_ok(r, ch, d, elem) ? r : 0;
  *chunks = ch;
}

}  // namespace

// shape[3] = {rows per CTA, chunks per segment, shared memory bytes} of the
// launch for B rows of T steps at block size d: rows = chunks = 0 on entry
// asks for the launcher's choice, else the given shape is checked.
extern "C" int bidiag_scan_config(int B, int T, int d, int is_double, int* shape) {
  const int elem = is_double ? 8 : 4;
  if (B < 1 || T < 1 || d < 2 || d > kMaxD || d % 2) return (int)cudaErrorInvalidValue;
  if (shape[0] == 0 && shape[1] == 0) choose_shape(B, T, d, elem, &shape[0], &shape[1]);
  if (!shape_ok(shape[0], shape[1], d, elem)) return (int)cudaErrorInvalidValue;
  shape[2] = (int)smem_layout(d, shape[1], shape[0], elem);
  return 0;
}

// S1 at a given shape (rows per CTA, chunks per segment): x, y: d planes
// [B, T] at strides (plane, batch, time) in elements (y must not overlap x);
// dinv, a, phi: contiguous [T, d, d] tables of the direction (a = A_fwd or
// A_bwd, phi its chunk prefix products over chunks of `chunk` steps, which
// must be kChunk); float32, or float64 when is_double; d even up to 16.
extern "C" int bidiag_scan_launch_shaped(const void* x, long long x_sp, long long x_sb,
                                         long long x_st, void* y, long long y_sp, long long y_sb,
                                         long long y_st, const void* dinv, const void* a,
                                         const void* phi, int B, int T, int d, int is_double,
                                         int backward, int chunk, int rows, int chunks,
                                         void* stream) {
  int shape[3] = {rows, chunks, 0};
  if (chunk != kChunk || x_sp < 0 || x_sb < 0 || x_st < 0 || y_sp < 0 || y_sb < 0 || y_st < 0 ||
      bidiag_scan_config(B, T, d, is_double, shape) != 0)
    return (int)cudaErrorInvalidValue;
  const Strides gx{x_sp, x_sb, x_st}, gy{y_sp, y_sb, y_st};
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return backward ? dispatch<double, true>(d, x, gx, y, gy, dinv, a, phi, B, T, rows, chunks, s)
                    : dispatch<double, false>(d, x, gx, y, gy, dinv, a, phi, B, T, rows, chunks, s);
  return backward ? dispatch<float, true>(d, x, gx, y, gy, dinv, a, phi, B, T, rows, chunks, s)
                  : dispatch<float, false>(d, x, gx, y, gy, dinv, a, phi, B, T, rows, chunks, s);
}

// S1 at the launcher's shape (bidiag_scan_config); arguments as above.
extern "C" int bidiag_scan_launch(const void* x, long long x_sp, long long x_sb, long long x_st,
                                  void* y, long long y_sp, long long y_sb, long long y_st,
                                  const void* dinv, const void* a, const void* phi, int B,
                                  int T, int d, int is_double, int backward, int chunk,
                                  void* stream) {
  int shape[3] = {0, 0, 0};
  if (B < 1 || T < 1 || bidiag_scan_config(B, T, d, is_double, shape) != 0)
    return (int)cudaErrorInvalidValue;
  return bidiag_scan_launch_shaped(x, x_sp, x_sb, x_st, y, y_sp, y_sb, y_st, dinv, a, phi, B, T,
                                   d, is_double, backward, chunk, shape[0], shape[1], stream);
}
