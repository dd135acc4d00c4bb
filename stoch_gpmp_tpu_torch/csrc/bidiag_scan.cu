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
// float32 or float64, d even up to 16. The block sizes of the repo's robots
// are compiled in (d = 4: the planar robot, d = 14: the Panda); any other
// even d takes the runtime-d instantiation (D = 0), which keeps its vectors
// in local memory. The tables, built once per factor
// (ops/kernels/bidiag_scan.py), do not depend on b:
//   rec [kChunk nch, R1]: per step D_t^{-1}'s triangle (by rows of D^{-1}
//                forward, of D^{-T} backward) then A_t, padded to an odd
//                number of 16-byte units (rec_elems);
//   phr [kChunk nch, d*d]: phi_t, the product of the transitions from the start
//                of t's chunk of kChunk steps (backward: from its end) up
//                to t; both zero-padded to whole chunks;
//   psi [kLevels, d*d, nch]: the products of 2^l consecutive chunk
//                transitions ending (backward: starting) at each chunk.
//
// Bound on the H100: bytes. A solve reads and writes the planes once (at
// T = 4096, B = 480, d = 4, float32: 62.9 MB, 18.8 us at 3.35 TB/s) and
// does ~2.5 d^2 FMAs per (b, t).
//
// Design (one launch, no synchronisation across CTAs):
// - A CTA holds R batch rows and walks time in segments of NC chunks of
//   kChunk steps (backward: from the last segment to the first). Its
//   consumer warps compute; one producer warp moves the data.
// - Planes: where the layout allows it (time stride 1, T a multiple of a
//   128-byte line, 16-byte strides and base), a segment is one TMA box of a
//   4-D tensor map (line of time, row, line index, plane) into a buffer in
//   shared memory, 128-byte swizzled so that the 16-byte reads of a warp's
//   (row, chunk) lanes hit distinct banks; with NB buffers, segment
//   q + NB - 1 loads and segment q - 1 is stored by TMA while segment q
//   computes. Other layouts (T = 77, stride-d planes) are staged by the
//   consumers with plain loads into the same layout (the launcher returns
//   -1 for them; the wrapper counts them).
// - Tables: the producer warp loads each stage (S steps of every chunk of
//   the segment) of rec (phase 1) or phr (phase 3) as one TMA box of a 3-D
//   map (entry, chunk, step) into a ring of NS stages, completion on one
//   mbarrier per stage (entries over 256 elements: one bulk copy per
//   chunk); consumers wait on the stage they read and release it by
//   another mbarrier. No CTA barrier per step. A warp's lanes are R rows x
//   KW chunks (rows fastest), so one read of a table entry serves R rows.
// - Phase 1: lane (row r, chunk k) runs its chunk's recurrence from a zero
//   carry, 16-byte reads and writes of V steps of a plane at a time, and
//   keeps the local result in place of x. Meanwhile the segment's psi
//   entries arrive in shared memory by cp.async.
// - Phase 2: the carries. Each warp scans the affine chunk maps (Psi_k,
//   local end e_k) of its rows over its KW chunks in log2(KW) shuffle steps;
//   the warps' aggregates cross through shared memory (a named barrier of
//   the consumers per segment) and every warp composes them in order with
//   the segment's carry; a second scan spreads each warp's incoming carry
//   over its chunks.
// - Phase 3: y_t = local_t + phi_t carry_in, in place; then the buffer is
//   stored by TMA (or by the consumers).
// - The launcher picks the shape (choose_shape): the most rows per CTA (up
//   to 8) that still launch nine tenths of the SMs' worth of CTAs, eight
//   consumer warps' chunks (no more than the row has), and the largest
//   stage, ring and buffer count that fit the shared memory.
//   bidiag_scan_launch_shaped takes a given shape, to sweep.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;       // steps per chunk (the phi tables' chunk)
constexpr int kLevels = 6;       // psi: spans of 1, 2, ..., 32 chunks
constexpr int kMaxD = 16;        // the largest block size (the runtime-d vectors)
constexpr int kMaxWarps = 8;     // consumer warps per CTA
constexpr int kSmemLimit = 232448;
constexpr long long kHangCycles = 20000000000LL;  // ~10 s: a lost barrier traps

struct Strides {  // in elements
  long long plane, batch, time;
};

// The launch shape: rows per CTA, chunks per segment, steps per table
// stage, plane buffers, table stages.
struct Shape {
  int rows, chunks, steps, buffers, stages;
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

// n values padded to an odd number of 16-byte units: the entries of a
// warp's chunks, side by side in shared memory, start on distinct banks.
__host__ __device__ constexpr int odd_units(int n, int elem) {
  return ((n + 16 / elem - 1) / (16 / elem) | 1) * (16 / elem);
}

// Elements of a rec entry (the triangle and A) and of a phr entry (phi;
// d * d is a whole number of 16-byte units for even d; a warp's quarter
// reads two chunks' entries at 4 rows per CTA, on distinct banks).
__host__ __device__ constexpr int rec_elems(int d, int elem) {
  return odd_units(d * (d + 1) / 2 + d * d, elem);
}

__host__ __device__ constexpr int phr_elems(int d, int) { return d * d; }

// Whether a table stage is one TMA box (entries of at most 256 elements);
// else one bulk copy per chunk.
__host__ __device__ inline bool table_boxes(int d, int elem) { return rec_elems(d, elem) <= 256; }

__host__ __device__ inline int warp_chunks(const Shape& s) {
  return 32 / s.rows < s.chunks ? 32 / s.rows : s.chunks;
}

__host__ __device__ inline int consumer_warps(const Shape& s) {
  return s.chunks / warp_chunks(s);
}

// A table stage in shared memory, in elements: [step][chunk][entry] as the
// TMA box lands, or (bulk copies) [chunk][step][entry] with chunks
// chunk_stride apart, s rec entries and 16 bytes (an odd number of 16-byte
// units); rounded to 128 bytes.
__host__ __device__ inline int chunk_stride(int d, int elem, int steps) {
  return steps * rec_elems(d, elem) + 16 / elem;
}

__host__ __device__ inline size_t stage_elems(int d, int elem, const Shape& s) {
  const size_t n = table_boxes(d, elem) ? (size_t)s.steps * s.chunks * rec_elems(d, elem)
                                        : (size_t)s.chunks * chunk_stride(d, elem, s.steps);
  return (n * elem + 127) / 128 * 128 / elem;
}

// 128-byte lines a row's segment of one plane takes in a buffer.
__host__ __device__ inline int seg_lines(int chunks, int elem) {
  return (chunks * kChunk * elem + 127) / 128;
}

__host__ __device__ inline size_t box_bytes(int d, int elem, const Shape& s) {
  return (size_t)d * s.rows * seg_lines(s.chunks, elem) * 128;
}

// The psi entries of a segment in shared memory: levels 0 .. log2(KW) - 1
// of every chunk (the scans within a warp), level log2(KW) at each warp's
// edge chunk (the warps' composition).
__host__ __device__ inline int psi_segment(int d, const Shape& s) {
  int l = 0;
  for (int w = warp_chunks(s); w > 1; w >>= 1) ++l;
  return d * d * (l * s.chunks + consumer_warps(s));
}

struct Layout {  // byte offsets from the 1024-byte aligned base
  size_t buffer, ring, agg, psi, bars, total;
};

__host__ __device__ inline Layout smem_layout(int d, int elem, const Shape& s) {
  Layout l;
  l.buffer = (box_bytes(d, elem, s) + 1023) / 1024 * 1024;
  l.ring = s.buffers * l.buffer;
  l.agg = l.ring + (size_t)s.stages * stage_elems(d, elem, s) * elem;
  l.psi = l.agg + (size_t)2 * consumer_warps(s) * s.rows * d * elem;
  l.bars = (l.psi + (size_t)2 * psi_segment(d, s) * elem + 7) / 8 * 8;
  l.total = l.bars + (size_t)16 * (s.buffers + s.stages) + 1024;  // + the alignment slack
  return l;
}

// Element offset, in a segment buffer, of step j of chunk k of plane i of
// row r: the TMA box's layout (a 128-byte line of time, the rows, the lines
// of the segment, the planes), each line's 16-byte units XOR-swizzled by
// the line's index mod 8 (CU_TENSOR_MAP_SWIZZLE_128B).
template <typename F>
__device__ __forceinline__ int buf_index(int i, int r, int k, int j, int rows, int chunks) {
  constexpr int LW = 128 / sizeof(F);
  const int t = k * kChunk + j, line = (i * seg_lines(chunks, sizeof(F)) + t / LW) * rows + r;
  const int o = (line * LW + t % LW) * (int)sizeof(F);
  return (o ^ ((line & 7) << 4)) / (int)sizeof(F);
}

// --- barriers and asynchronous copies (PTX) ------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* b, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits for the phase of parity `parity` to complete; traps (an error at
// the next synchronisation, not a hang) if it has not after kHangCycles.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  if (mbar_try_wait(b, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(b, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

__device__ __forceinline__ void named_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// --- the arithmetic ------------------------------------------------------------

// A table entry of N elements: in registers by 16-byte loads (D <= 8), or
// read from shared memory as the arithmetic reaches it.
template <typename F, int N>
struct InRegs {
  F v[N];
  __device__ __forceinline__ explicit InRegs(const F* p) {
    using VT = typename VecOf<F>::type;
    constexpr int V = VecOf<F>::n;
#pragma unroll
    for (int q = 0; q < N / V; ++q) {
      const VT w = reinterpret_cast<const VT*>(p)[q];
      const F* wf = reinterpret_cast<const F*>(&w);
#pragma unroll
      for (int e = 0; e < V; ++e) v[q * V + e] = wf[e];
    }
  }
  __device__ __forceinline__ F operator[](int e) const { return v[e]; }
};

template <typename F>
struct InSmem {
  const F* p;
  __device__ __forceinline__ explicit InSmem(const F* q) : p(q) {}
  __device__ __forceinline__ F operator[](int e) const { return p[e]; }
};

template <typename F, int D, int N>
__device__ __forceinline__ auto entry(const F* p) {
  if constexpr (D != 0 && D <= 8)
    return InRegs<F, N>(p);
  else
    return InSmem<F>(p);
}

// One step of phase 1: loc = A_t loc + D_t^{-1(T)} x_t, from a rec entry.
template <typename F, int D, bool kBack>
__device__ __forceinline__ void step1(const F* rec_p, int d_rt, const F* xs, F* loc) {
  constexpr int DA = D ? D : kMaxD;
  const int d = D ? D : d_rt;
  const auto m = entry<F, D, rec_elems(D ? D : 2, sizeof(F))>(rec_p);
  F nl[DA];
  int o = 0;
#pragma unroll
  for (int i = 0; i < d; ++i) {
    F c = F(0);
    if (kBack) {
#pragma unroll
      for (int j = i; j < d; ++j) c = fma(m[o++], xs[j], c);
    } else {
#pragma unroll
      for (int j = 0; j <= i; ++j) c = fma(m[o++], xs[j], c);
    }
    nl[i] = c;
  }
  const int a0 = d * (d + 1) / 2;
#pragma unroll
  for (int i = 0; i < d; ++i) {
    F c = nl[i];
#pragma unroll
    for (int j = 0; j < d; ++j) c = fma(m[a0 + i * d + j], loc[j], c);
    nl[i] = c;
  }
#pragma unroll
  for (int i = 0; i < d; ++i) loc[i] = nl[i];
}

// out = v + M w for the d x d matrix M of a psi level at a chunk: the
// segment's copy in shared memory, [level][i * d + j][chunk], at chunk k.
template <typename F, int D>
__device__ __forceinline__ void psi_apply(const F* psi_s, int lvl, int k, int chunks, int d_rt,
                                          const F* v, const F* w, F* out) {
  constexpr int DA = D ? D : kMaxD;
  const int d = D ? D : d_rt, dd = d * d;
  const F* q = psi_s + (size_t)lvl * dd * chunks + k;
  F o[DA];
#pragma unroll
  for (int i = 0; i < d; ++i) {
    F c = v[i];
#pragma unroll
    for (int j = 0; j < d; ++j) c = fma(q[(i * d + j) * chunks], w[j], c);
    o[i] = c;
  }
#pragma unroll
  for (int i = 0; i < d; ++i) out[i] = o[i];
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)), "l"(src),
               "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <typename F>
struct Args {
  const F* x;
  F* y;
  Strides gx, gy;
  const F* rec;  // [kChunk nch, rec_elems] of the direction
  const F* phr;  // [kChunk nch, phr_elems]
  const F* psi;  // [kLevels, d * d, nch]
  int B, T, d, nch;
  Shape sh;
  int tma;  // planes by TMA (else staged by the consumers)
};

// Moves the segment's planes between device memory and the buffer with
// plain loads and stores, by every consumer thread (the layouts TMA does not
// take). kIn: device to shared (zeros beyond T and B), else shared to device.
template <typename F, bool kIn>
__device__ __forceinline__ void stage(const Args<F>& a, F* buf, int b0, int t0, int ctid,
                                      int ncons) {
  const int R = a.sh.rows, NC = a.sh.chunks, L = NC * kChunk;
  const int total = a.d * R * L;
#pragma unroll 4
  for (int e = ctid; e < total; e += ncons) {
    const int s = e % L, rest = e / L, r = rest % R, i = rest / R;
    const int t = t0 + s, b = b0 + r;
    const bool in = t < a.T && b < a.B;
    F* sp = buf + buf_index<F>(i, r, s / kChunk, s % kChunk, R, NC);
    if constexpr (kIn) {
      *sp = in ? __ldg(a.x + i * a.gx.plane + b * a.gx.batch + t * a.gx.time) : F(0);
    } else if (in) {
      a.y[i * a.gy.plane + b * a.gy.batch + t * a.gy.time] = *sp;
    }
  }
}

template <typename F, int D, bool kBack>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32)
    bidiag_scan_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmy,
                       const __grid_constant__ CUtensorMap tmr,
                       const __grid_constant__ CUtensorMap tmp, const Args<F> a) {
  using VT = typename VecOf<F>::type;
  constexpr int V = VecOf<F>::n;
  constexpr int DA = D ? D : kMaxD;
  constexpr int LW = 128 / sizeof(F);
  // a step's arithmetic unrolled over a vector's steps for the small block
  // sizes only (the Panda's d = 14 would multiply the code and the build)
  constexpr int kUnrollV = D != 0 && D <= 8 ? V : 1;
  const int d = D ? D : a.d, dd = d * d;
  const Shape sh = a.sh;
  const int R = sh.rows, NC = sh.chunks, S = sh.steps, NB = sh.buffers, NS = sh.stages;
  const int KW = warp_chunks(sh), NW = consumer_warps(sh), ncons = NW * 32;
  const int L = NC * kChunk, nseg = (a.T + L - 1) / L, nst = kChunk / S;
  const int re = rec_elems(D ? D : d, (int)sizeof(F)), pe3 = phr_elems(D ? D : d, (int)sizeof(F));
  const int cs = chunk_stride(d, (int)sizeof(F), S);
  const bool boxes = table_boxes(d, (int)sizeof(F));
  const Layout lay = smem_layout(d, (int)sizeof(F), sh);
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned (the TMA swizzle's period); offsets from smem_raw keep
  // the accesses below in the shared window (LDS / STS, not generic loads)
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  F* bufs = reinterpret_cast<F*>(base);
  F* ring = reinterpret_cast<F*>(base + lay.ring);
  F* agg = reinterpret_cast<F*>(base + lay.agg);  // [2][NW][R][d] warp aggregates
  F* psi_sm = reinterpret_cast<F*>(base + lay.psi);  // [2][levels][d * d][NC] psi of a segment
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);  // [NS] stage landed
  uint64_t* empty = full + NS;                                     // [NS] stage released
  uint64_t* loaded = empty + NS;                                   // [NB] buffer loaded
  uint64_t* computed = loaded + NB;                                // [NB] buffer computed
  const size_t buf_elems = lay.buffer / sizeof(F);
  const size_t stage_n = stage_elems(d, (int)sizeof(F), sh);
  const int b0 = blockIdx.x * R;
  const uint32_t box = (uint32_t)box_bytes(d, (int)sizeof(F), sh);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ncons);
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&computed[s], ncons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == NW) {
    // --- the producer warp: table stages and, by TMA, the planes ------------
    auto load = [&](int q) {
      const int seg = kBack ? nseg - 1 - q : q;
      mbar_expect_tx(&loaded[q % NB], box);
      tma_load(bufs + (size_t)(q % NB) * buf_elems, &tmx, 0, b0, seg * L / LW, 0,
               &loaded[q % NB]);
    };
    auto store = [&](int q) {
      const int seg = kBack ? nseg - 1 - q : q;
      mbar_wait(&computed[q % NB], (q / NB) & 1);
      tma_store(&tmy, bufs + (size_t)(q % NB) * buf_elems, 0, b0, seg * L / LW, 0);
    };
    if (a.tma && lane == 0)
      for (int q = 0; q < NB && q < nseg; ++q) load(q);
    int slot = 0;
    uint32_t parity = 0;
    for (int q = 0; q < nseg; ++q) {
      const int seg = kBack ? nseg - 1 - q : q;
      if (a.tma && lane == 0 && NB == 1 && q > 0) {  // one buffer: store, then load
        store(q - 1);
        bulk_wait_read();
        load(q);
      }
      for (int ph = 0; ph < 2; ++ph) {
        const F* tab = ph == 0 ? a.rec : a.phr;
        const int te = ph == 0 ? re : pe3;
        for (int st = 0; st < nst; ++st) {
          const int pl = kBack ? kChunk - (st + 1) * S : st * S;
          mbar_wait(&empty[slot], parity ^ 1);
          if (boxes) {  // one box: S steps of the segment's chunks, [step][chunk][entry]
            if (lane == 0) {
              mbar_expect_tx(&full[slot], (uint32_t)(S * NC * te * sizeof(F)));
              tma_load3(ring + slot * stage_n, ph == 0 ? &tmr : &tmp, 0, seg * NC, pl,
                        &full[slot]);
            }
          } else {  // per chunk: S steps, [chunk][step][entry]
            const uint32_t n_on = (uint32_t)max(0, min(NC, a.nch - seg * NC));
            if (lane == 0) mbar_expect_tx(&full[slot], n_on * S * te * (uint32_t)sizeof(F));
            __syncwarp();
            for (int k = lane; k < (int)n_on; k += 32)
              bulk_copy(ring + slot * stage_n + (size_t)k * cs,
                        tab + ((size_t)(seg * NC + k) * kChunk + pl) * te,
                        (uint32_t)(S * te * sizeof(F)), &full[slot]);
          }
          // the previous segment's store once this one's first stages are in
          // flight; the next load once that store has left the buffer
          if (a.tma && lane == 0 && NB > 1 && q > 0 && ph == 0 &&
              st == min(NS, nst) - 1)
            store(q - 1);
          if (++slot == NS) {
            slot = 0;
            parity ^= 1;
          }
        }
        if (a.tma && lane == 0 && NB > 1 && q > 0 && ph == 0 && q - 1 + NB < nseg) {
          bulk_wait_read();
          load(q - 1 + NB);
        }
      }
    }
    if (a.tma && lane == 0) {
      store(nseg - 1);
      bulk_wait();
    }
    return;
  }

  // --- the consumer warps: lane (row r, chunk kl of the warp's KW) -----------
  const int r = lane % R, kl = lane / R;
  const bool lane_on = kl < KW;
  const int k = warp * KW + kl;  // the chunk in the segment
  const int lk = __ffs(KW) - 1;   // log2 KW: the psi level of a warp's span
  const int psi_elems = psi_segment(d, sh), psi_scan = lk * dd * NC, lnc = __ffs(NC) - 1;
  const bool edge_in = kBack ? kl == KW - 1 : kl == 0;  // where a warp's carry enters
  int lbase[DA];  // the buffer line of (plane i, row r, step 0): buf_index, hoisted
#pragma unroll
  for (int i = 0; i < d; ++i) lbase[i] = i * seg_lines(NC, sizeof(F)) * R + r;
  auto bidx = [&](int i, int j) {
    const int t = k * kChunk + j, line = lbase[i] + (t / LW) * R;
    return line * LW + ((t % LW) ^ ((line & 7) * (16 / (int)sizeof(F))));
  };
  F cseg[DA];  // the row's carry into the segment
#pragma unroll
  for (int i = 0; i < d; ++i) cseg[i] = F(0);
  int slot = 0;           // the table stage's ring slot
  uint32_t parity = 0;    // and the parity of its use
  auto next_slot = [&] {
    if (++slot == NS) {
      slot = 0;
      parity ^= 1;
    }
  };
  for (int q = 0; q < nseg; ++q) {
    const int seg = kBack ? nseg - 1 - q : q;
    const int kg = seg * NC + k;
    const bool valid = lane_on && kg < a.nch;
    const int nk = valid ? min(kChunk, a.T - kg * kChunk) : 0;
    F* buf = bufs + (a.tma ? (size_t)(q % NB) * buf_elems : 0);
    // the segment's psi levels into shared memory, waited for in phase 2
    F* psi_s = psi_sm + (size_t)(q & 1) * psi_elems;
    for (int e2 = threadIdx.x; e2 < psi_elems; e2 += ncons) {
      int row, kc;  // [level * d * d + entry][chunk], then level lk [entry][warp]
      if (e2 < psi_scan) {
        row = e2 >> lnc;
        kc = e2 & (NC - 1);
      } else {
        const int ew = e2 - psi_scan, w = ew % NW;
        row = lk * dd + ew / NW;
        kc = w * KW + (kBack ? 0 : KW - 1);
      }
      if (seg * NC + kc < a.nch)
        cp_async<sizeof(F)>(psi_s + e2, a.psi + (size_t)row * a.nch + seg * NC + kc);
    }
    if (a.tma) {
      mbar_wait(&loaded[q % NB], (q / NB) & 1);
    } else {
      named_sync(ncons);  // the previous segment is written back
      stage<F, true>(a, buf, b0, seg * L, threadIdx.x, ncons);
      named_sync(ncons);
    }

    // phase 1: the chunk's recurrence from a zero carry, local results in place
    F loc[DA];
#pragma unroll
    for (int i = 0; i < d; ++i) loc[i] = F(0);
    for (int st = 0; st < nst; ++st, next_slot()) {
      const int pl = kBack ? kChunk - (st + 1) * S : st * S;
      mbar_wait(&full[slot], parity);
      const F* tab = ring + slot * stage_n + (size_t)k * (boxes ? re : cs);
      const int sstep = boxes ? NC * re : re;  // between a chunk's steps
      for (int g = 0; g < S / V; ++g) {
        const int gb = kBack ? pl + S - (g + 1) * V : pl + g * V;  // the group's first slot
        if (gb >= nk) continue;
        F xv[DA][V];
#pragma unroll
        for (int i = 0; i < d; ++i) {
          const VT w = *reinterpret_cast<const VT*>(buf + bidx(i, gb));
          const F* wf = reinterpret_cast<const F*>(&w);
#pragma unroll
          for (int v = 0; v < V; ++v) xv[i][v] = wf[v];
        }
#pragma unroll kUnrollV
        for (int v = 0; v < V; ++v) {
          const int vv = kBack ? V - 1 - v : v, p = gb + vv;
          if (p < nk) {
            F xs[DA];
#pragma unroll
            for (int i = 0; i < d; ++i) xs[i] = xv[i][vv];
            step1<F, D, kBack>(tab + (size_t)(p - pl) * sstep, d, xs, loc);
#pragma unroll
            for (int i = 0; i < d; ++i) xv[i][vv] = loc[i];
          }
        }
#pragma unroll
        for (int i = 0; i < d; ++i) {
          VT w;
          F* wf = reinterpret_cast<F*>(&w);
#pragma unroll
          for (int v = 0; v < V; ++v) wf[v] = xv[i][v];
          *reinterpret_cast<VT*>(buf + bidx(i, gb)) = w;
        }
      }
      mbar_arrive(&empty[slot]);
    }

    // phase 2: the carries. Scan the chunk maps (Psi_k, e_k) over the warp's
    // chunks (forward: from lower chunks; backward: from higher ones).
    F e[DA], f[DA], cin[DA], pe[DA];
#pragma unroll
    for (int i = 0; i < d; ++i) e[i] = loc[i];
    cp_async_wait_all();
    named_sync(ncons);  // the segment's psi copy has landed
    for (int lv = 0, step = 1; step < KW; ++lv, step <<= 1) {
#pragma unroll
      for (int i = 0; i < d; ++i)
        pe[i] = kBack ? __shfl_down_sync(0xffffffffu, e[i], step * R)
                      : __shfl_up_sync(0xffffffffu, e[i], step * R);
      if (valid && (kBack ? kl + step < KW && kg + step < a.nch : kl >= step))
        psi_apply<F, D>(psi_s, lv, k, NC, d, e, pe, e);
    }
    // the warps' aggregates, then each warp's incoming carry (every warp
    // composes them all, so every warp also holds the next segment's carry)
    F* ag = agg + (size_t)(q & 1) * NW * R * d;
    if (lane_on && (kBack ? kl == 0 : kl == KW - 1)) {
#pragma unroll
      for (int i = 0; i < d; ++i) ag[(warp * R + r) * d + i] = e[i];
    }
    named_sync(ncons);
    for (int u = 0; u < NW; ++u) {
      const int ww = kBack ? NW - 1 - u : u;
      if (ww == warp) {
#pragma unroll
        for (int i = 0; i < d; ++i) cin[i] = cseg[i];
      }
      const int kf = seg * NC + ww * KW, kx = kBack ? kf : kf + KW - 1;
      if (kf >= a.nch) continue;  // no chunk of this warp holds steps
      const F* w = ag + (ww * R + r) * d;
      if (kx < a.nch) {
        psi_apply<F, D>(psi_s + psi_scan, 0, ww, NW, d, w, cseg, cseg);
      } else {  // forward, the last segment's last warp: its carry is not used
#pragma unroll
        for (int i = 0; i < d; ++i) cseg[i] = w[i];
      }
    }
    // spread the warp's carry over its chunks: f_k = (Psi_k ... Psi_edge) cin
#pragma unroll
    for (int i = 0; i < d; ++i) f[i] = F(0);
    if (valid && edge_in) psi_apply<F, D>(psi_s, 0, k, NC, d, f, cin, f);
    for (int lv = 0, step = 1; step < KW; ++lv, step <<= 1) {
#pragma unroll
      for (int i = 0; i < d; ++i)
        pe[i] = kBack ? __shfl_down_sync(0xffffffffu, f[i], step * R)
                      : __shfl_up_sync(0xffffffffu, f[i], step * R);
      if (valid && (kBack ? kl + step < KW && kg + step < a.nch : kl >= step))
        psi_apply<F, D>(psi_s, lv, k, NC, d, f, pe, f);
    }
    // y at each chunk's far end; the carry into a chunk is its neighbour's
#pragma unroll
    for (int i = 0; i < d; ++i) {
      const F y_end = e[i] + f[i];
      const F nb = kBack ? __shfl_down_sync(0xffffffffu, y_end, R)
                         : __shfl_up_sync(0xffffffffu, y_end, R);
      cin[i] = edge_in ? cin[i] : nb;
    }

    // phase 3: y_t = local_t + phi_t carry_in, in place
    for (int st = 0; st < nst; ++st, next_slot()) {
      const int pl = kBack ? kChunk - (st + 1) * S : st * S;
      mbar_wait(&full[slot], parity);
      const F* tab = ring + slot * stage_n + (size_t)k * (boxes ? pe3 : cs);
      const int sstep = boxes ? NC * pe3 : pe3;
      for (int g = 0; g < S / V; ++g) {
        const int gb = pl + g * V;
        if (gb >= nk) continue;
        F lv[DA][V];
#pragma unroll
        for (int i = 0; i < d; ++i) {
          const VT w = *reinterpret_cast<const VT*>(buf + bidx(i, gb));
          const F* wf = reinterpret_cast<const F*>(&w);
#pragma unroll
          for (int v = 0; v < V; ++v) lv[i][v] = wf[v];
        }
#pragma unroll kUnrollV
        for (int v = 0; v < V; ++v) {
          if (gb + v >= nk) continue;
          const auto p =
              entry<F, D, (D ? D : 2) * (D ? D : 2)>(tab + (size_t)(gb + v - pl) * sstep);
#pragma unroll
          for (int i = 0; i < d; ++i) {
            F c = lv[i][v];
#pragma unroll
            for (int j = 0; j < d; ++j) c = fma(p[i * d + j], cin[j], c);
            lv[i][v] = c;
          }
        }
#pragma unroll
        for (int i = 0; i < d; ++i) {
          VT w;
          F* wf = reinterpret_cast<F*>(&w);
#pragma unroll
          for (int v = 0; v < V; ++v) wf[v] = lv[i][v];
          *reinterpret_cast<VT*>(buf + bidx(i, gb)) = w;
        }
      }
      mbar_arrive(&empty[slot]);
    }
    if (a.tma) {
      fence_proxy_async();  // the writes above, before the TMA store reads them
      mbar_arrive(&computed[q % NB]);
    } else {
      named_sync(ncons);
      stage<F, false>(a, buf, b0, seg * L, threadIdx.x, ncons);
    }
  }
}

// --- the host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (null if absent).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// A tiled map of `rank` dimensions (strides in bytes, of dimensions 1 ..),
// through a small cache: a map is a function of these arguments alone, so
// equal arguments give equal maps (the planner's planes are new tensors each
// iteration, mostly at the same addresses).
template <typename F>
bool encode(CUtensorMap* map, int rank, const void* p, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  struct Key {
    const void* p;
    int rank, swizzle;
    cuuint64_t dims[4], strides[3];
    cuuint32_t box[4];
  };
  struct Entry {
    Key key;
    CUtensorMap map;
  };
  static thread_local Entry cache[8] = {};
  static thread_local int next = 0;
  Key k{};
  k.p = p;
  k.rank = rank;
  k.swizzle = (int)swizzle;
  for (int i = 0; i < rank; ++i) {
    k.dims[i] = dims[i];
    k.box[i] = box[i];
    if (i + 1 < rank) k.strides[i] = strides[i];
  }
  auto same = [&](const Key& o) {
    if (o.p != k.p || o.rank != k.rank || o.swizzle != k.swizzle) return false;
    for (int i = 0; i < 4; ++i)
      if (o.dims[i] != k.dims[i] || o.box[i] != k.box[i] || (i < 3 && o.strides[i] != k.strides[i]))
        return false;
    return true;
  };
  for (const Entry& e : cache)
    if (e.key.p && same(e.key)) {
      *map = e.map;
      return true;
    }
  const EncodeTiled fn = encoder();
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (!fn || fn(map, sizeof(F) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
                rank, const_cast<void*>(p), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = Entry{k, *map};
  next = (next + 1) % 8;
  return true;
}

// Whether TMA takes the planes at p: time stride 1, T a multiple of a
// 128-byte line, 16-byte aligned base and strides.
template <typename F>
bool tma_layout(const void* p, Strides g, int T) {
  constexpr int LW = 128 / sizeof(F);
  return g.time == 1 && T % LW == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (g.batch * sizeof(F)) % 16 == 0 && (g.plane * sizeof(F)) % 16 == 0;
}

// The 4-D map (a line of time, rows, lines, planes) of the planes at p, a
// box being one segment of the CTA's rows, 128-byte swizzled.
template <typename F>
bool plane_map(CUtensorMap* map, const void* p, Strides g, int B, int T, int d, const Shape& s) {
  constexpr int LW = 128 / sizeof(F);
  const cuuint64_t dims[4] = {(cuuint64_t)LW, (cuuint64_t)B, (cuuint64_t)(T / LW), (cuuint64_t)d};
  const cuuint64_t strides[3] = {(cuuint64_t)(g.batch * sizeof(F)), 128,
                                 (cuuint64_t)(g.plane * sizeof(F))};
  const cuuint32_t box[4] = {(cuuint32_t)LW, (cuuint32_t)s.rows,
                             (cuuint32_t)seg_lines(s.chunks, sizeof(F)), (cuuint32_t)d};
  return encode<F>(map, 4, p, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The 3-D map (entry, chunk, step in the chunk) of a [kChunk nch, e] table, a
// box being one stage: s steps of the segment's chunks, [step][chunk][entry].
template <typename F>
bool table_map(CUtensorMap* map, const void* p, int e, int nch, const Shape& s) {
  const cuuint64_t dims[3] = {(cuuint64_t)e, (cuuint64_t)nch, (cuuint64_t)kChunk};
  const cuuint64_t strides[2] = {(cuuint64_t)kChunk * e * sizeof(F), (cuuint64_t)e * sizeof(F)};
  const cuuint32_t box[3] = {(cuuint32_t)e, (cuuint32_t)s.chunks, (cuuint32_t)s.steps};
  return encode<F>(map, 3, p, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// 0 when the planes went by TMA, -1 when the consumers staged them, else
// the cudaError_t.
template <typename F, int D, bool kBack>
int launch(const void* x, Strides gx, void* y, Strides gy, const void* rec, const void* phr,
           const void* psi, int B, int T, int d, const Shape& s, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  auto kernel = bidiag_scan_kernel<F, D, kBack>;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int nch = (T + kChunk - 1) / kChunk, elem = (int)sizeof(F);
  Args<F> a{static_cast<const F*>(x), static_cast<F*>(y), gx, gy, static_cast<const F*>(rec),
            static_cast<const F*>(phr), static_cast<const F*>(psi), B, T, d, nch, s, 0};
  CUtensorMap mx{}, my{}, mr{}, mp{};
  a.tma = tma_layout<F>(x, gx, T) && tma_layout<F>(y, gy, T) &&
          s.chunks * kChunk * elem % 128 == 0;  // a box of whole lines
  if (a.tma && !(plane_map<F>(&mx, x, gx, B, T, d, s) && plane_map<F>(&my, y, gy, B, T, d, s)))
    return (int)cudaErrorInvalidValue;
  if (table_boxes(d, elem) && !(table_map<F>(&mr, rec, rec_elems(d, elem), nch, s) &&
                                table_map<F>(&mp, phr, phr_elems(d, elem), nch, s)))
    return (int)cudaErrorInvalidValue;
  kernel<<<(B + s.rows - 1) / s.rows, (consumer_warps(s) + 1) * 32,
           smem_layout(d, elem, s).total, stream>>>(mx, my, mr, mp, a);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? (int)e : (a.tma ? 0 : -1);
}

// d = 4 and 14 compiled in, any other even d up to kMaxD at runtime (D = 0).
template <typename F, bool kBack>
int dispatch(int d, const void* x, Strides gx, void* y, Strides gy, const void* rec,
             const void* phr, const void* psi, int B, int T, const Shape& s, cudaStream_t st) {
  switch (d) {
    case 4: return launch<F, 4, kBack>(x, gx, y, gy, rec, phr, psi, B, T, d, s, st);
    case 14: return launch<F, 14, kBack>(x, gx, y, gy, rec, phr, psi, B, T, d, s, st);
    default: return launch<F, 0, kBack>(x, gx, y, gy, rec, phr, psi, B, T, d, s, st);
  }
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// Whether s is a shape the kernel takes at block size d.
bool shape_ok(const Shape& s, int d, int elem) {
  const int v = 16 / elem;
  if (!(s.rows == 1 || s.rows == 2 || s.rows == 4 || s.rows == 8) || !pow2(s.chunks) ||
      !pow2(s.steps) || s.steps < v || s.steps > kChunk || s.buffers < 1 || s.stages < 2 ||
      seg_lines(s.chunks, elem) > 256)
    return false;
  return consumer_warps(s) <= kMaxWarps &&
         smem_layout(d, elem, s).total <= (size_t)kSmemLimit;
}

// The launch shape for B rows of T steps on the current device (see the
// design above); rows = 0 when none fits.
void choose_shape(int B, int T, int d, int elem, Shape* out) {
  static int sm_count[16] = {};  // per device, asked once
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) dev = 0;
  if (sm_count[dev] == 0 &&
      cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sm_count[dev] = 132;
  const int sms = sm_count[dev];
  Shape s{1, 1, 8, 2, 3};
  for (int c = 8; c > 1; c /= 2)
    if ((B + c - 1) / c >= sms * 9 / 10) {
      s.rows = c;
      break;
    }
  const int nch = (T + kChunk - 1) / kChunk;
  s.chunks = 8 * (32 / s.rows);  // eight consumer warps
  while (s.chunks > 1 && s.chunks / 2 >= nch) s.chunks /= 2;
  if (s.steps < 16 / elem) s.steps = 16 / elem;
  if ((T + s.chunks * kChunk - 1) / (s.chunks * kChunk) == 1) s.buffers = 1;
  while (!shape_ok(s, d, elem)) {
    if (s.stages > 2)
      --s.stages;
    else if (s.steps > 16 / elem)
      s.steps /= 2;
    else if (s.buffers > 1)
      --s.buffers;
    else if (s.chunks > 1)
      s.chunks /= 2;
    else
      break;
  }
  if (!shape_ok(s, d, elem)) s.rows = 0;
  *out = s;
}

}  // namespace

// shape[7] = {rows per CTA, chunks per segment, steps per table stage, plane
// buffers, table stages, shared memory bytes, threads} of the launch for B
// rows of T steps at block size d: rows = 0 on entry asks for the
// launcher's choice, else the given shape (the first five) is checked.
extern "C" int bidiag_scan_config(int B, int T, int d, int is_double, int* shape) {
  const int elem = is_double ? 8 : 4;
  if (B < 1 || T < 1 || d < 2 || d > kMaxD || d % 2) return (int)cudaErrorInvalidValue;
  Shape s{shape[0], shape[1], shape[2], shape[3], shape[4]};
  if (s.rows == 0) choose_shape(B, T, d, elem, &s);
  if (!shape_ok(s, d, elem)) return (int)cudaErrorInvalidValue;
  const int out[7] = {s.rows, s.chunks, s.steps, s.buffers, s.stages,
                      (int)smem_layout(d, elem, s).total, (consumer_warps(s) + 1) * 32};
  for (int i = 0; i < 7; ++i) shape[i] = out[i];
  return 0;
}

// S1 at a given shape (int shape[5] as bidiag_scan_config takes it): x, y:
// d planes [B, T] at strides (plane, batch, time) in elements (y must not
// overlap x); rec, phr, psi: the direction's contiguous tables (see the
// top; phr and psi over chunks of `chunk` steps, which must be kChunk, psi
// of `levels` levels, which must be kLevels); float32, or float64 when
// is_double; d even up to 16. Returns 0 (planes by TMA), -1 (planes staged
// by the consumers) or a cudaError_t.
extern "C" int bidiag_scan_launch_shaped(const void* x, long long x_sp, long long x_sb,
                                         long long x_st, void* y, long long y_sp, long long y_sb,
                                         long long y_st, const void* rec, const void* phr,
                                         const void* psi, int B, int T, int d, int is_double,
                                         int backward, int chunk, int levels, const int* shape,
                                         void* stream) {
  int sh[7] = {shape[0], shape[1], shape[2], shape[3], shape[4], 0, 0};
  if (chunk != kChunk || levels != kLevels || sh[0] == 0 || x_sp < 0 || x_sb < 0 || x_st < 0 ||
      y_sp < 0 || y_sb < 0 || y_st < 0 || reinterpret_cast<uintptr_t>(rec) % 16 ||
      reinterpret_cast<uintptr_t>(phr) % 16 || bidiag_scan_config(B, T, d, is_double, sh) != 0)
    return (int)cudaErrorInvalidValue;
  const Strides gx{x_sp, x_sb, x_st}, gy{y_sp, y_sb, y_st};
  const Shape s{sh[0], sh[1], sh[2], sh[3], sh[4]};
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return backward ? dispatch<double, true>(d, x, gx, y, gy, rec, phr, psi, B, T, s, st)
                    : dispatch<double, false>(d, x, gx, y, gy, rec, phr, psi, B, T, s, st);
  return backward ? dispatch<float, true>(d, x, gx, y, gy, rec, phr, psi, B, T, s, st)
                  : dispatch<float, false>(d, x, gx, y, gy, rec, phr, psi, B, T, s, st);
}

// S1 at the launcher's shape (bidiag_scan_config); arguments as above.
extern "C" int bidiag_scan_launch(const void* x, long long x_sp, long long x_sb, long long x_st,
                                  void* y, long long y_sp, long long y_sb, long long y_st,
                                  const void* rec, const void* phr, const void* psi, int B, int T,
                                  int d, int is_double, int backward, int chunk, int levels,
                                  void* stream) {
  int shape[7] = {0, 0, 0, 0, 0, 0, 0};
  if (B < 1 || T < 1 || bidiag_scan_config(B, T, d, is_double, shape) != 0)
    return (int)cudaErrorInvalidValue;
  return bidiag_scan_launch_shaped(x, x_sp, x_sb, x_st, y, y_sp, y_sb, y_st, rec, phr, psi, B, T,
                                   d, is_double, backward, chunk, levels, shape, stream);
}
