// Closest-hit ray casting over a nearest-first list of culled chunks, two
// rays per thread, with an exact early stop, for sm_90a.
//
// Replaces the TPU kernels of habitat_tpu/ops/raycast_pallas.py:
//   C = 32        <- raycast_pallas_exactsel_t / _exactsel_kernel_t
//                    (the exact-culled 32-triangle chunklets of a 32x32-pixel
//                    tile, from select_chunklets_exact)
//   C = 128, 256  <- raycast_pallas_stream_t / _stream_kernel_t
//                    (parent chunks from select_chunks_occluded, or any
//                    nearest-first chunk list such as an all-chunks oracle)
// Both are one kernel; the chunk size C (a multiple of 32) is an argument.
//
// What it computes, per (env, ray): the ray features F (10) = B[env]^T [d,1];
// then, for the tile's listed chunks in list order, the four Möller–Trumbore
// determinants G = M_chunk^T F of every triangle and the sign-free margin
//   min(min(p, q), aa - p - q, w - TMIN*aa, aa - EPS^2) >= 0
// with aa = detA^2, p = u*detA, q = v*detA, w = tnum*detA; a hit has
// t = tnum / detA. Strict < across chunks and lanes keeps the first minimum.
// Misses give t = 1e6, idx = -1; idx = chunk id * C + lane is a global
// triangle index.
//
// Each list slot packs (dmin_cm << 18) | chunk id: dmin is the least distance
// at which any ray from the camera can meet the chunk's bounds, floored to
// centimetres, and the list ascends in it. Once every ray of a block holds a
// hit nearer than the current slot's dmin, no later chunk can improve any of
// them and the block stops. A warp whose 64 rays are all already nearer
// skips the arithmetic. Both skips leave the result as if every listed chunk
// were tested, except for a hit whose float32 t lands below its own chunk's
// floored dmin. Slots at or beyond cnt[env, tile] are padding and are not
// read.
//
// Design for an H100. A block is 256 rays of a 32x32-pixel tile (8 pixel
// rows: the granularity of the block's stop), 128 threads of 2 rays each:
// warp w takes the two pixel rows [64w, 64w + 64), lane l the rays l and
// l + 32. Each 16-byte shared-memory load of a
// coefficient row (four triangles) feeds 2 rays x 4 lanes = 8 FMAs. The
// list is staged in units of 32 lanes (a chunklet, or an eighth of a
// 256-triangle chunk), 5 KB each, through a ring of 2 stages filled with
// 16-byte cp.async copies: unit q + 1 is in flight while unit q is tested,
// and the stop vote (__syncthreads_or) is the one barrier per unit, which
// also frees the stage the next copy goes into. A unit prefetched past the
// stop costs only its bytes. For 4 lanes x 2 rays, detA, unum and vnum are
// summed and the margin's p, q and aa - p - q terms tested term by term
// (x - y >= 0 iff x >= y for finite floats, so the same hits as the min
// form); only if the line of some ray of the warp meets one of the 4
// triangles is tnum summed and the rest tested, and the IEEE division
// runs only for a hit that can be nearer than the ray's best (|tnum| < best
// |detA| (1 + 1e-4); beyond it t >= best for certain). Every result is the
// one the whole test gives.
//
// What bounds it: FP32 issue. A test is 30 FMAs, ~8 other FP32 operations
// and ~4 shared loads, and 10 FMAs more where a ray's line meets the
// triangle; 160 B of coefficients per triangle are read once per block
// from L2 (neighbouring tiles list the same chunklets). The early stop
// decides how many tests there are: on the scan reset a block stages 57.4
// of a tile's 96.1 listed chunklets and a 64-ray warp computes 55.6, where
// a ray's final hit needs 46.5 (chip_smoke.py's counters). On an H100,
// more rays per thread (4) and a deeper ring (4 stages) each measured
// slower.
//
// Numerics: no fast math, IEEE division. F and the margin use explicitly
// rounded multiplies and adds (no FMA contraction), as the plain PyTorch
// version computes them; the determinant dots use fmaf.
//
// Layouts (row-major, float32 unless noted):
//   tri_mat_c (S, 10, 4T)   chunk c in columns [c*4C, (c+1)*4C) as
//                           [detA(C) | tnum(C) | unum(C) | vnum(C)];
//                           16-byte aligned
//   sids      (N,)          int32 scene per env
//   chunk_ids (N, nt, K)    int32 packed slots, survivors first
//   cnt       (N, nt)       int32 survivors per (env, tile)
//   d_t       (nt, 8, Rt)   rows 0:4 are the camera-frame [d, 1] of the tile
//   bt        (N, 16, 4)    rows 0:10 are B^T
//   t_out     (N, nt*Rt)    idx_out (N, nt*Rt) int32

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTMax = 1e6f;
constexpr float kTMin = 1e-3f;
constexpr float kEps2 = 1e-14f;  // (1e-7)^2
constexpr int kIdMask = (1 << 18) - 1;
constexpr int kRays = 2;                      // rays per thread
constexpr int kBlockRays = 256;               // rays per block: 8 pixel rows of a tile
constexpr int kThreads = kBlockRays / kRays;  // 128
constexpr int kWarpRays = 32 * kRays;         // rays per warp: 2 pixel rows
// The ring holds kStages units of 32 lanes (a chunklet, or an eighth of a
// 256-triangle chunk): 10 rows of [detA | tnum | unum | vnum] x 32, 5 KB.
constexpr int kUnit = 32;
constexpr int kStages = 2;
constexpr int kUnitFloats = 10 * 4 * kUnit;
constexpr int kSmem = kStages * kUnitFloats * (int)sizeof(float);

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

// Issue the 16-byte copies of unit u (lanes [32u, 32u + 32)) of chunk cid,
// whose row i holds [detA(C) | tnum(C) | unum(C) | vnum(C)] at columns
// [cid * 4C, (cid + 1) * 4C), into dst.
__device__ __forceinline__ void issue_unit(float* dst, const float* m_g, int t4, int C,
                                           int cid, int u) {
  const float* src = m_g + (size_t)cid * 4 * C + u * kUnit;
  for (int e = threadIdx.x; e < kUnitFloats / 4; e += kThreads) {
    const int seg = e >> 3;  // row i * 4 + determinant k
    const int w = (e & 7) * 4;
    cp_async16(dst + seg * kUnit + w, src + (size_t)(seg >> 2) * t4 + (seg & 3) * C + w);
  }
}

// Determinant k (0 detA, 1 tnum, 2 unum, 3 vnum) of lanes [j, j + 4) of a
// staged unit for the thread's rays: one 16-byte broadcast load feeds 4
// lanes x kRays rays.
__device__ __forceinline__ void dots(const float* m_s, int j, int k,
                                     const float (&f)[kRays][10],
                                     float (&g)[kRays][4]) {
#pragma unroll
  for (int r = 0; r < kRays; ++r)
#pragma unroll
    for (int l = 0; l < 4; ++l) g[r][l] = 0.f;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(m_s + (i * 4 + k) * kUnit + j);
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      g[r][0] = fmaf(f[r][i], a.x, g[r][0]);
      g[r][1] = fmaf(f[r][i], a.y, g[r][1]);
      g[r][2] = fmaf(f[r][i], a.z, g[r][2]);
      g[r][3] = fmaf(f[r][i], a.w, g[r][3]);
    }
  }
}

// False only where tn / det >= best for certain (the division, the costly
// step of a hit, is then skipped): |tn| >= best |det| (1 + 1e-4) leaves a
// margin far wider than the few ulps of rounding on either side.
__device__ __forceinline__ bool nearer(float tn, float det, float best) {
  return fabsf(tn) < best * fabsf(det) * 1.0001f;
}

__global__ void __launch_bounds__(kThreads) stream_raycast_kernel(
    const float* __restrict__ tri_mat_c, const int* __restrict__ sids,
    const int* __restrict__ chunk_ids, const int* __restrict__ cnt,
    const float* __restrict__ d_t, const float* __restrict__ bt,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    int t4, int nt, int k_max, int rt, int C) {
  extern __shared__ __align__(16) float ring[];  // kStages x kUnitFloats
  const int env = blockIdx.y;
  const int slices = rt / kBlockRays;
  const int tile = blockIdx.x / slices;
  // warp w holds rays [w * 64, w * 64 + 64) of the block: lane l takes l and l + 32
  const int r0 = (blockIdx.x % slices) * kBlockRays + (threadIdx.x >> 5) * kWarpRays +
                 (threadIdx.x & 31);
  const int sid = sids[env];

  float f[kRays][10];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = d_t[(size_t)(tile * 8 + k) * rt + r0 + 32 * r];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const float* b = bt + ((size_t)env * 16 + i) * 4;
      float acc = __fmul_rn(b[0], d[0]);
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = __fadd_rn(acc, __fmul_rn(b[k], d[k]));
      f[r][i] = acc;
    }
  }

  const int et = env * nt + tile;
  const int units = C / kUnit;  // per list slot
  const int n_units = min(cnt[et], k_max) * units;
  const int* list = chunk_ids + (size_t)et * k_max;
  const float* m_g = tri_mat_c + (size_t)sid * 10 * t4;
  float best_t[kRays];
  int best_i[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    best_t[r] = kTMax;
    best_i[r] = -1;
  }
  // the ring: unit q (slot q / units) sits in stage q % kStages; the copies
  // of the next kStages - 1 units are in flight while unit q is tested
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_units) issue_unit(ring + s * kUnitFloats, m_g, t4, C, list[s / units] & kIdMask, s % units);
    cp_async_commit();
  }
  for (int q = 0; q < n_units; ++q) {
    const int slot = list[q / units];
    const int cid = slot & kIdMask;
    const float dmin = __fmul_rn((float)(slot >> 18), 1e-2f);
    bool open = false;
#pragma unroll
    for (int r = 0; r < kRays; ++r) open |= best_t[r] > dmin;
    cp_async_wait<kStages - 2>();
    // unit q has landed for every thread and unit q - 1 is consumed; stop
    // when no ray of the block is open
    if (!__syncthreads_or(open)) break;
    const int qn = q + kStages - 1;
    if (qn < n_units)
      issue_unit(ring + (qn % kStages) * kUnitFloats, m_g, t4, C, list[qn / units] & kIdMask, qn % units);
    cp_async_commit();
    if (!__any_sync(0xffffffffu, open)) continue;
    const float* m_s = ring + (q % kStages) * kUnitFloats;
    const int base = cid * C + (q % units) * kUnit;
    for (int j = 0; j < kUnit; j += 4) {
      // the margin min(min(p, q), aa - p - q, w - TMIN*aa, aa - EPS^2) >= 0
      // term by term (x - y >= 0 iff x >= y for finite floats); tnum is
      // summed only where the line of some ray of the warp meets a triangle
      float det[kRays][4], p[kRays][4], g[kRays][4];
      unsigned inside = 0;  // bit 4r + l: p, q and aa - p - q pass
      dots(m_s, j, 0, f, det);
      dots(m_s, j, 2, f, g);  // unum
#pragma unroll
      for (int r = 0; r < kRays; ++r)
#pragma unroll
        for (int l = 0; l < 4; ++l) p[r][l] = __fmul_rn(g[r][l], det[r][l]);
      dots(m_s, j, 3, f, g);  // vnum
#pragma unroll
      for (int r = 0; r < kRays; ++r)
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const float aa = __fmul_rn(det[r][l], det[r][l]);
          const float q = __fmul_rn(g[r][l], det[r][l]);
          if (p[r][l] >= 0.f && q >= 0.f && __fsub_rn(aa, p[r][l]) >= q) inside |= 1u << (4 * r + l);
        }
      if (!__any_sync(0xffffffffu, inside != 0)) continue;
      dots(m_s, j, 1, f, g);  // tnum
#pragma unroll
      for (int r = 0; r < kRays; ++r)
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const float d = det[r][l];
          const float aa = __fmul_rn(d, d);
          const float w = __fmul_rn(g[r][l], d);
          if ((inside >> (4 * r + l) & 1u) && w >= __fmul_rn(kTMin, aa) && aa >= kEps2 &&
              nearer(g[r][l], d, best_t[r])) {
            const float t = g[r][l] / d;
            if (t < best_t[r]) {
              best_t[r] = t;
              best_i[r] = base + j + l;
            }
          }
        }
    }
  }
  cp_async_wait<0>();  // no copy may land after the block has left
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const size_t out = (size_t)env * nt * rt + (size_t)tile * rt + r0 + 32 * r;
    const bool miss = best_t[r] >= kTMax * 0.5f;
    t_out[out] = miss ? kTMax : best_t[r];
    idx_out[out] = miss ? -1 : best_i[r];
  }
}

}  // namespace

extern "C" {

// Visits chunk_ids[env, tile, :cnt[env, tile]] nearest first; tri_chunk is
// 32 (exact-culled chunklets) or a multiple of 32 (parent chunks of 128 or
// 256). block_rays and warp_rays are the caller's idea of the early stop's
// granularity (the plain version counts by them) and must be the kernel's.
int raycast_stream(const void* tri_mat_c, const void* sids,
                   const void* chunk_ids, const void* cnt, const void* d_t,
                   const void* bt, void* t_out, void* idx_out, int n_env,
                   int t4, int nt, int k_max, int rt, int tri_chunk,
                   int block_rays, int warp_rays, void* stream) {
  if (chunk_ids == nullptr || cnt == nullptr || rt % kBlockRays != 0 ||
      tri_chunk <= 0 || tri_chunk % kUnit != 0 || t4 % (4 * tri_chunk) != 0 ||
      (uintptr_t)tri_mat_c % 16 != 0 || block_rays != kBlockRays ||
      warp_rays != kWarpRays)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nt * (rt / kBlockRays), n_env);
  stream_raycast_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float*)tri_mat_c, (const int*)sids, (const int*)chunk_ids,
      (const int*)cnt, (const float*)d_t, (const float*)bt, (float*)t_out,
      (int*)idx_out, t4, nt, k_max, rt, tri_chunk);
  return (int)cudaGetLastError();
}

// The kernel's design: out = {rays per thread, rays per block, rays per
// warp, ring stages (units of 32 lanes), registers per thread, local
// (spilled) bytes per thread, static shared bytes, dynamic shared bytes,
// blocks per SM}.
int raycast_stream_design(int* out) {
  const void* kernel = (const void*)stream_raycast_kernel;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, kSmem);
  if (err) return err;
  const int v[9] = {kRays, kBlockRays, kWarpRays, kStages, attr.numRegs,
                    (int)attr.localSizeBytes, (int)attr.sharedSizeBytes, kSmem, blocks};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
