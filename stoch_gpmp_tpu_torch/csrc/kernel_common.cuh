// Device helpers shared by the fused iteration kernels
// (fused_planar_step.cu, fused_panda_step.cu, fused_panda_dof_step.cu): the
// Philox4x32-10 counter-based generator with a dual-output Box-Muller, warp
// and block reductions, and the cp.async K-tile pipeline that multiplies a
// tile of rows in shared memory by a matrix streamed from device memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Philox4x32-10 (Salmon et al., SC'11) on a 128-bit counter and 64-bit key.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Dual-output Box-Muller on the top 24 bits, u1 in (0, 1) as in the TPU
// kernels' _box_muller (ops/pallas/fused_step.py): r cos and r sin are both
// used.
__device__ __forceinline__ float2 box_muller(uint32_t b1, uint32_t b2) {
  const float u1 = (float)(b1 >> 8) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
  const float u2 = (float)(b2 >> 8) * (1.0f / 16777216.0f);
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(6.283185307179586f * u2, &s, &c);
  return make_float2(r * c, r * s);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum or max; every thread gets the result. scratch: 32 floats.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < nwarps; ++w) r = IS_MAX ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

// 16-byte asynchronous global -> shared copy (Ampere and later), so the next
// K-tile is in flight while the current one is multiplied.
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copy of K-tile kt of G [M, M] (KT rows) into buf.
template <int KT>
__device__ __forceinline__ void load_ktile(const float* __restrict__ G, float* buf, int kt,
                                           int M) {
  const float4* src = reinterpret_cast<const float4*>(G + (size_t)kt * KT * M);
  float4* dst = reinterpret_cast<float4*>(buf);
  for (int j = threadIdx.x; j < KT * M / 4; j += blockDim.x) cp_async16(dst + j, src + j);
  cp_async_commit();
}

// acc[c][i] += sum_k xs[i][k] * G[k][m] for the ST rows of the tile in
// shared memory and the C columns m = threadIdx.x + c * blockDim.x of each
// thread (C * blockDim.x == M); G [M, M] streams through the two KT-row
// buffers of g_sh, the copy of K-tile kt+1 overlapping the products of
// K-tile kt. M must be a multiple of KT and 4.
template <int ST, int KT, int C>
__device__ __forceinline__ void tile_matmul_cols(const float* xs, const float* __restrict__ G,
                                                 float* g_sh, int M, float (&acc)[C][ST]) {
  const int nkt = M / KT;
  __syncthreads();  // every earlier reader of g_sh and writer of xs is done
  load_ktile<KT>(G, g_sh, 0, M);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load_ktile<KT>(G, g_sh + ((kt + 1) & 1) * KT * M, kt + 1, M);
      cp_async_wait<1>();  // K-tile kt has landed (kt+1 may still fly)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... for every thread's share of it
    const float* gt = g_sh + (kt & 1) * KT * M;
    const int k0 = kt * KT;
    // four K steps per pass: the row operand is one 16-byte broadcast load
    for (int kk = 0; kk < KT; kk += 4) {
      float g[C][4];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int m = threadIdx.x + c * blockDim.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) g[c][j] = gt[(kk + j) * M + m];
      }
#pragma unroll
      for (int i = 0; i < ST; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(xs + i * M + k0 + kk);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[c][i] = fmaf(a.x, g[c][0], acc[c][i]);
          acc[c][i] = fmaf(a.y, g[c][1], acc[c][i]);
          acc[c][i] = fmaf(a.z, g[c][2], acc[c][i]);
          acc[c][i] = fmaf(a.w, g[c][3], acc[c][i]);
        }
      }
    }
    __syncthreads();  // buffer kt & 1 is consumed before it is refilled
  }
}

// tile_matmul_cols with one column per thread (blockDim.x == M).
template <int ST, int KT>
__device__ __forceinline__ void tile_matmul(const float* xs, const float* __restrict__ G,
                                            float* g_sh, int M, float (&acc)[ST]) {
  tile_matmul_cols<ST, KT, 1>(xs, G, g_sh, M, reinterpret_cast<float(&)[1][ST]>(acc));
}

}  // namespace
