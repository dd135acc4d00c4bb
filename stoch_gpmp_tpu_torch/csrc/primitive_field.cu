// Analytic primitive field: the count of rectangles and circles containing
// each query point.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/fields.py
// primitive_field_cost (_primitive_kernel):
//   count += [|x - cx| <= w/2 and |y - cy| <= h/2]      per rectangle
//   count += [(x - cx)^2 + (y - cy)^2 <= r^2]           per circle
//
// Bound on the H100: memory and launch latency. A point reads 8 bytes and
// writes 4, with about 6 operations per primitive (120,960 points and 15
// primitives per StochGPMP iteration at the planar parity shape). Design:
// one thread per point, the [B, L, 2] points read through their strides;
// the primitives sit in shared memory and R = 0 or C = 0 is a loop count of
// zero (the TPU kernel pads an empty class to one dummy row). Each test is
// exact on its rounded operands, so every step is an explicit IEEE
// round-to-nearest intrinsic: nvcc may not contract a product and a sum
// into one FMA here, and a point on a primitive's boundary counts as it
// does in the plain PyTorch version.

#include <cuda_runtime.h>

__global__ void primitive_field_kernel(const float* __restrict__ pts, long long B,
                                       long long L, long long sb, long long sl,
                                       long long sc, const float* __restrict__ rects,
                                       int n_rects, const float* __restrict__ circles,
                                       int n_circles, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_rects = smem;                 // [R][4]: cx, cy, w/2, h/2
  float* s_circles = smem + 4 * n_rects;  // [C][3]: cx, cy, r^2
  for (int i = threadIdx.x; i < 4 * n_rects; i += blockDim.x)
    s_rects[i] = (i & 3) >= 2 ? __fmul_rn(0.5f, rects[i]) : rects[i];
  for (int i = threadIdx.x; i < 3 * n_circles; i += blockDim.x)
    s_circles[i] = i % 3 == 2 ? __fmul_rn(circles[i], circles[i]) : circles[i];
  __syncthreads();
  const long long n = B * L;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / L, l = idx - b * L;
    const float* p = pts + b * sb + l * sl;
    const float x = p[0], y = p[sc];
    float acc = 0.0f;
    for (int r = 0; r < n_rects; ++r) {
      const float* rc = s_rects + 4 * r;
      if (fabsf(__fsub_rn(x, rc[0])) <= rc[2] && fabsf(__fsub_rn(y, rc[1])) <= rc[3])
        acc += 1.0f;
    }
    for (int c = 0; c < n_circles; ++c) {
      const float* ci = s_circles + 3 * c;
      const float dx = __fsub_rn(x, ci[0]), dy = __fsub_rn(y, ci[1]);
      if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= ci[2]) acc += 1.0f;
    }
    out[idx] = acc;
  }
}

extern "C" int primitive_field_launch(const float* pts, long long B, long long L,
                                      long long sb, long long sl, long long sc,
                                      const float* rects, int n_rects,
                                      const float* circles, int n_circles, float* out,
                                      void* stream) {
  const int threads = 256;
  long long blocks = (B * L + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride covers the rest
  if (blocks < 1) blocks = 1;
  const size_t smem = sizeof(float) * (4 * n_rects + 3 * n_circles);
  primitive_field_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      pts, B, L, sb, sl, sc, rects, n_rects, circles, n_circles, out);
  return (int)cudaGetLastError();
}
