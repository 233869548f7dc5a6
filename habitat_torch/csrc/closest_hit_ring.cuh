// The closest-hit loop of the ring kernels, for sm_90a: walk_chunks and
// test_lanes serve the index kernels (#3, #8) of raycast_general.cu and the
// fused kernels (#1, #2) of raycast_fused.cu; the culled kernels (#7, #9)
// of raycast_general.cu share the ring's pieces (cp.async, issue_chunk,
// dots, the design query) and write the same loop out themselves.
//
// What bounds the loop on an H100: FP32 issue. A ray-triangle test is 30
// FMAs and ~8 other FP32 operations, 10 FMAs and a few operations more (an
// IEEE division on a hit) where the ray's line meets the triangle, against
// 160 B of coefficients per triangle, read once per block from L2, 40 B of
// features and 8-36 B of output per ray. The design:
//   - one block of kThreads = 256 threads per slab of kBlockRays = 1024
//     rays, kRays = 4 rays per thread (rays r, r + 256, r + 512, r + 768 of
//     the slab), so each chunk is staged once per 1024 rays; rays past the
//     slab's end are computed with zero features (they never pass the
//     margin) and never written, and take part in every barrier and vote;
//   - each 16-byte broadcast load of a coefficient row (four consecutive
//     triangles) feeds 4 lanes x 4 rays = 16 FMAs; each determinant is fmaf
//     over i = 0..9 in order from 0, and lanes are visited in order with a
//     strict <, so the first minimum wins;
//   - a ring of kStages = 2 chunk stages (dynamic shared memory) filled with
//     16-byte cp.async copies: chunk k + 1 is in flight while chunk k is
//     tested, and one barrier per chunk both publishes chunk k and frees the
//     stage of chunk k - 1;
//   - the determinants summed one at a time (detA, unum into p, vnum, then
//     tnum), so that at most three sets of 16 sums are live: 128 registers,
//     no spills, two blocks per SM.
// The margin is tested term by term, with the expressions of the plain
// version rounded the same way: p >= 0, q >= 0, aa - p >= q (for any two
// values but the same infinity, (aa - p) - q >= 0), aa - EPS^2 >= 0 (> 0
// under the split margin); only then is tnum summed, for a group of 4 lanes
// and only if some ray of the warp passes those terms for one of them
// (__any_sync), and w - TMIN*aa >= 0 (> 0 split) tested. A NaN fails every
// comparison, so a NaN term makes a miss: the kernels follow torch.minimum,
// which propagates NaN into the plain version's min, not fminf.
//
// Numerics: no fast math, so the division is IEEE. The margin terms use
// explicitly rounded multiplies and adds (no FMA contraction); the
// determinant dots use fmaf.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTMax = 1e6f;
constexpr float kTMin = 1e-3f;
constexpr float kEps2 = 1e-14f;  // (1e-7)^2
constexpr int kThreads = 256;
constexpr int kRays = 4;                        // rays per thread
constexpr int kBlockRays = kThreads * kRays;    // rays per block
constexpr int kStages = 2;                      // chunks in the ring

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Row (i, k) of chunk cid, row = 4i + k: feature i of determinant k (0
// detA, 1 tnum, 2 unum, 3 vnum) for the chunk's C triangles.
//   kGrouped false: the pack's (10, 4, T) matrix, columns [cid C, (cid+1) C)
//                   of row 4i + k;
//   kGrouped true:  group_tri_mat's (10, 4T) matrix, chunk cid in columns
//                   [cid 4C, (cid+1) 4C) of row i as [detA|tnum|unum|vnum].
template <bool kGrouped>
__device__ __forceinline__ const float* chunk_row(const float* m_g, int T, int C, int cid, int row) {
  if (kGrouped) return m_g + (size_t)(row >> 2) * 4 * T + (size_t)cid * 4 * C + (row & 3) * C;
  return m_g + (size_t)row * T + (size_t)cid * C;
}

// Issue the 16-byte copies of chunk cid's 40 rows of C coefficients into
// dst, 40 x C. kC: the chunk size, or 0 for the C argument.
template <bool kGrouped, int kC>
__device__ __forceinline__ void issue_chunk(float* dst, const float* m_g, int C, int T, int cid) {
  const int C_ = kC ? kC : C;
  const int q = C_ / 4;
  for (int e = threadIdx.x; e < 40 * q; e += kThreads) {
    const int row = e / q;
    const int c4 = (e - row * q) * 4;
    cp_async16(dst + row * C_ + c4, chunk_row<kGrouped>(m_g, T, C_, cid, row) + c4);
  }
}

// The determinant k of four consecutive lanes [j, j + 4) for each of the
// thread's rays: one 16-byte broadcast load of a coefficient row feeds 4
// lanes x kRays rays.
template <int kC>
__device__ __forceinline__ void dots(const float* m_s, int C, int j, int k,
                                     const float (&f)[kRays][10],
                                     float (&g)[kRays][4]) {
  const int C_ = kC ? kC : C;
#pragma unroll
  for (int r = 0; r < kRays; ++r)
#pragma unroll
    for (int l = 0; l < 4; ++l) g[r][l] = 0.f;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(m_s + (4 * i + k) * C_ + j);
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      g[r][0] = fmaf(f[r][i], a.x, g[r][0]);
      g[r][1] = fmaf(f[r][i], a.y, g[r][1]);
      g[r][2] = fmaf(f[r][i], a.z, g[r][2]);
      g[r][3] = fmaf(f[r][i], a.w, g[r][3]);
    }
  }
}

// Lanes [j, j + 4) of the staged chunk m_s against the thread's rays, the
// margin term by term (the split one under kSplit, else the fused one);
// hits fold into (best_t, best_i) as triangle base + j + l.
template <bool kSplit, int kC>
__device__ __forceinline__ void test_lanes(const float* m_s, int C, int j, int base,
                                           const float (&f)[kRays][10],
                                           float (&best_t)[kRays], int (&best_i)[kRays]) {
  float det[kRays][4], p[kRays][4], g[kRays][4];
  unsigned inside = 0;  // bit 4r + l: p, q, aa - p - q and aa - EPS^2 pass
  dots<kC>(m_s, C, j, 0, f, det);
  dots<kC>(m_s, C, j, 2, f, g);  // unum
#pragma unroll
  for (int r = 0; r < kRays; ++r)
#pragma unroll
    for (int l = 0; l < 4; ++l) p[r][l] = __fmul_rn(g[r][l], det[r][l]);
  dots<kC>(m_s, C, j, 3, f, g);  // vnum
#pragma unroll
  for (int r = 0; r < kRays; ++r)
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float aa = __fmul_rn(det[r][l], det[r][l]);
      const float q = __fmul_rn(g[r][l], det[r][l]);
      if (p[r][l] >= 0.f && q >= 0.f && __fsub_rn(aa, p[r][l]) >= q && (kSplit ? aa > kEps2 : aa >= kEps2))
        inside |= 1u << (4 * r + l);
    }
  // tnum is summed only where the line of some ray of the warp meets a triangle
  if (!__any_sync(0xffffffffu, inside != 0)) return;
  dots<kC>(m_s, C, j, 1, f, g);  // tnum
#pragma unroll
  for (int r = 0; r < kRays; ++r)
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float aa = __fmul_rn(det[r][l], det[r][l]);
      const float m = __fsub_rn(__fmul_rn(g[r][l], det[r][l]), __fmul_rn(kTMin, aa));
      if ((inside >> (4 * r + l) & 1u) && (kSplit ? m > 0.f : m >= 0.f)) {
        const float t = g[r][l] / det[r][l];
        if (t < best_t[r]) {
          best_t[r] = t;
          best_i[r] = base + j + l;
        }
      }
    }
}

// The n chunks list[0..n) (or 0..n without a list; list may lie in shared
// or device memory) in order through the ring in smem (kStages x 40 x C),
// from the scene matrix m_g (kGrouped: see chunk_row) of T triangles.
// Every thread of the block calls it with the same n.
template <bool kGrouped, bool kSplit, int kC>
__device__ __forceinline__ void walk_chunks(float* smem, const float* m_g, int C, int T,
                                            const int* list, int n,
                                            const float (&f)[kRays][10],
                                            float (&best_t)[kRays], int (&best_i)[kRays]) {
  const int C_ = kC ? kC : C;
  // chunk k sits in stage k % kStages; the copy of chunk k + kStages - 1 is
  // in flight while chunk k is tested
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) issue_chunk<kGrouped, kC>(smem + s * 40 * C_, m_g, C_, T, list ? list[s] : s);
    cp_async_commit();
  }
  for (int k = 0; k < n; ++k) {
    cp_async_wait<kStages - 2>();
    // chunk k has landed for every thread, and chunk k - 1 is consumed
    __syncthreads();
    const int kn = k + kStages - 1;
    if (kn < n) issue_chunk<kGrouped, kC>(smem + (kn % kStages) * 40 * C_, m_g, C_, T, list ? list[kn] : kn);
    cp_async_commit();
    const float* m_s = smem + (k % kStages) * 40 * C_;
    const int base = (list ? list[k] : k) * C_;
    for (int j = 0; j < C_; j += 4) test_lanes<kSplit, kC>(m_s, C_, j, base, f, best_t, best_i);
  }
  cp_async_wait<0>();
}

// Dynamic shared memory of a ring of C-triangle chunks.
inline int ring_smem(int C) { return kStages * 40 * C * (int)sizeof(float); }

int launch_config(const void* kernel, int smem_bytes) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// A ring kernel's design with smem dynamic shared bytes: out = {rays per
// thread, rays per block, rays per warp, ring stages, registers per thread,
// local (spilled) bytes per thread, static shared bytes, dynamic shared
// bytes, blocks per SM}.
int ring_design(const void* kernel, int smem, int* out) {
  int err = launch_config(kernel, smem);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (err) return err;
  const int v[9] = {kRays, kBlockRays, 32 * kRays, kStages, attr.numRegs,
                    (int)attr.localSizeBytes, (int)attr.sharedSizeBytes, smem, blocks};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

}  // namespace
