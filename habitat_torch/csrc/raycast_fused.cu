// Closest-hit ray casting against a whole scene or its frustum-selected
// chunks, for sm_90a.
//
// Replaces the TPU kernels of habitat_tpu/ops/raycast_pallas.py:
//   raycast_fused_sel   <- raycast_pallas_fused_sel_t / _fused_sel_kernel_t
//                          (the frustum-survivor chunk list, C = 32)
//   raycast_fused       <- raycast_pallas_fused_t / _fused_kernel_t
//                          (every chunk of the scene in order, C = 128)
//   raycast_tilecull    <- raycast_pallas_tilecull_t / _tilecull_kernel_t
//                          (a tile's surviving chunks, the winner's 16
//                          attr16 rows, plane-exact t and the shade)
// All three are one kernel: the second is the first with the chunk list
// 0, 1, ..., T/C - 1; the third is the first followed by an epilogue for
// every ray, misses included: it
// reads the winner's 16 rows [n(3), v0(3), gid, sem, rgb(3), valid, 4 pad]
// from attr16 (S, T/C, 16, C) once, at the end, instead of copying them out
// of each chunk that improves the hit, and with d = F[0:3], o = B^T[3:6, 3]:
//   nd = n.d, t = n.(v0 - o) / nd unless |nd| < 1e-6 (then the loop's t),
//   t = 1e6 on a miss, row 12 = 0.35 + 0.65 |nd| (0.35 on a miss, where the
//   rows are zero).
//
// What they compute, per (env, ray): the ray features F (10) = B[env]^T
// [d,1] from the env's (16, 4) feature matrix and the ray's camera-frame
// [d, 1]; for every triangle of every listed chunk the four Möller–Trumbore
// determinants G = M_chunk^T F (dot products of length 10) and the
// sign-free hit margin
//   min(min(p, q), aa - p - q, w - TMIN*aa, aa - EPS^2) >= 0
// with aa = detA^2, p = u*detA, q = v*detA, w = tnum*detA; a hit has
// t = tnum / detA. Chunks are visited in list order and triangles in lane
// order with a strict < throughout, which is the TPU kernel's argmin-first
// within a chunk and strict < across chunks. Misses give t = 1e6, idx = -1.
//
// What bounds them on an H100: FP32 issue. The bytes are small: the scene
// matrix is 160 B per triangle, read once per block from L2; each ray reads
// 16 B and writes 8 B (the tile-cull kernel 68 B). All three are one ring
// kernel (closest_hit_ring.cuh): one block of 256 threads per 1024 rays of
// a tile, 4 rays per thread, each ray's features built in registers with
// explicit rounding, a 2-stage cp.async ring of the listed chunks (min(cnt,
// K) of them, in list order), 16-byte broadcast loads of four lanes that
// feed 16 FMAs, the margin term by term and tnum only where a ray's line
// meets a triangle. On the bench path a 2048-ray tile's 2.5 listed chunks
// of 32 are staged twice, not eight times. The tile-cull kernel is the
// kernel's kAttrs form: after the loop each thread runs the epilogue for
// its 4 rays one at a time (16 rows live at once) and writes each row with
// consecutive rays at consecutive addresses. Listed ids must lie in [0,
// T/C), for all three as for the plain versions.
//
// Numerics: no fast math, so the division is IEEE. F and the margin terms
// use explicitly rounded multiplies and adds (no FMA contraction), matching
// the plain PyTorch version operation for operation; the determinant dots
// use fmaf.
//
// Layouts (row-major, float32 unless noted):
//   tri_mat_c (S, 10, 4T)   chunk c in columns [c*4C, (c+1)*4C) as
//                           [detA(C) | tnum(C) | unum(C) | vnum(C)];
//                           16-byte aligned for the ring kernels
//   sids      (N,)          int32 scene per env
//   chunk_ids (N, nt, K)    int32 survivors first; the tail is padding
//   cnt       (N, nt)       int32 survivors per (env, tile)
//   d_t       (nt, 8, Rt)   rows 0:4 are the camera-frame [d, 1] of the tile
//   bt        (N, 16, 4)    rows 0:10 are B^T
//   t_out     (N, nt*Rt)    idx_out (N, nt*Rt) int32
//   attr16    (S, T/C, 16, C)  tilecull: attr_out (N, nt, 16, Rt)

#include "closest_hit_ring.cuh"

namespace {

// F (10) = B[env]^T [d, 1], each row's four products summed in order with
// explicit rounding (no FMA contraction).
__device__ __forceinline__ void ray_features(const float* __restrict__ d_t,
                                             const float* __restrict__ bt,
                                             int env, int tile, int rt, int r,
                                             float (&f)[10]) {
  float d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = d_t[(size_t)(tile * 8 + k) * rt + r];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const float* b = bt + ((size_t)env * 16 + i) * 4;
    float acc = __fmul_rn(b[0], d[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) acc = __fadd_rn(acc, __fmul_rn(b[k], d[k]));
    f[i] = acc;
  }
}

// The tile-cull epilogue for one ray with features f and loop result
// (best_t, best_i): the winner's 16 rows of attr16 (zero without one; the
// scene's first chunk at chunk0), plane-exact t and the shade, with o =
// B^T[3:6, 3] from b = B^T.
template <int C>
__device__ __forceinline__ void tilecull_epilogue(const float* __restrict__ attr16, size_t chunk0,
                                                  const float* __restrict__ b, const float (&f)[10],
                                                  float best_t, int best_i, float* __restrict__ t_out,
                                                  float* __restrict__ dst, int rt) {
  float a[16];
  if (best_i >= 0) {
    const int cid = best_i / C;
    const float* src = attr16 + (chunk0 + cid) * 16 * C + (best_i - cid * C);
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = __ldg(src + i * C);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = 0.f;
  }
  const float nd = __fadd_rn(__fadd_rn(__fmul_rn(a[0], f[0]), __fmul_rn(a[1], f[1])), __fmul_rn(a[2], f[2]));
  const float num = __fadd_rn(
      __fadd_rn(__fmul_rn(a[0], __fsub_rn(a[3], b[3 * 4 + 3])),
                __fmul_rn(a[1], __fsub_rn(a[4], b[4 * 4 + 3]))),
      __fmul_rn(a[2], __fsub_rn(a[5], b[5 * 4 + 3])));
  const bool hit = best_t < kTMax * 0.5f;
  const bool grazing = fabsf(nd) < 1e-6f;
  const float t_pl = num / (grazing ? 1.f : nd);
  a[12] = __fadd_rn(0.35f, __fmul_rn(0.65f, fabsf(nd)));
  *t_out = hit ? (grazing ? best_t : t_pl) : kTMax;
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[(size_t)i * rt] = a[i];
}

// kAttrs false: t and idx (the frustum-selected and every-chunk kernels);
// true: t and the winner's rows (the tile-cull kernel; idx_out unused).
template <int C, bool kAttrs>
__global__ void __launch_bounds__(kThreads, 2) fused_raycast_kernel(
    const float* __restrict__ tri_mat_c, const float* __restrict__ attr16,
    const int* __restrict__ sids, const int* __restrict__ chunk_ids,
    const int* __restrict__ cnt, const float* __restrict__ d_t,
    const float* __restrict__ bt, float* __restrict__ t_out,
    int* __restrict__ idx_out, float* __restrict__ attr_out,
    int t4, int nt, int k_max, int rt) {
  extern __shared__ __align__(16) float smem[];  // kStages x 40 x C
  const int env = blockIdx.y;
  const int slabs = (rt + kBlockRays - 1) / kBlockRays;
  const int tile = blockIdx.x / slabs;
  const int r0 = (blockIdx.x % slabs) * kBlockRays + threadIdx.x;
  float f[kRays][10];
  float best_t[kRays];
  int best_i[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int ray = r0 + r * kThreads;
    if (ray < rt) {
      ray_features(d_t, bt, env, tile, rt, ray, f[r]);
    } else {  // past the tile: zero features never pass the margin
#pragma unroll
      for (int i = 0; i < 10; ++i) f[r][i] = 0.f;
    }
    best_t[r] = kTMax;
    best_i[r] = -1;
  }

  const int et = env * nt + tile;
  const int* list = chunk_ids ? chunk_ids + (size_t)et * k_max : nullptr;
  const int n_chunks = t4 / (4 * C);
  const int n = chunk_ids ? min(cnt[et], k_max) : n_chunks;
  const int sid = sids[env];
  walk_chunks<true, false, C>(smem, tri_mat_c + (size_t)sid * 10 * t4, C, t4 / 4, list, n, f, best_t, best_i);
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int ray = r0 + r * kThreads;
    if (ray >= rt) continue;
    const size_t out = (size_t)et * rt + ray;
    if (kAttrs) {
      tilecull_epilogue<C>(attr16, (size_t)sid * n_chunks, bt + (size_t)env * 16 * 4, f[r], best_t[r], best_i[r],
                           t_out + out, attr_out + (size_t)et * 16 * rt + ray, rt);
    } else {
      const bool miss = best_t[r] >= kTMax * 0.5f;
      t_out[out] = miss ? kTMax : best_t[r];
      idx_out[out] = miss ? -1 : best_i[r];
    }
  }
}

template <int C, bool kAttrs>
int launch(const void* tri_mat_c, const void* attr16, const void* sids, const void* chunk_ids, const void* cnt,
           const void* d_t, const void* bt, void* t_out, void* idx_out, void* attr_out, int n_env, int t4, int nt,
           int k_max, int rt, void* stream) {
  const dim3 grid(nt * ((rt + kBlockRays - 1) / kBlockRays), n_env);
  fused_raycast_kernel<C, kAttrs><<<grid, kThreads, ring_smem(C), (cudaStream_t)stream>>>(
      (const float*)tri_mat_c, (const float*)attr16, (const int*)sids, (const int*)chunk_ids, (const int*)cnt,
      (const float*)d_t, (const float*)bt, (float*)t_out, (int*)idx_out, (float*)attr_out, t4, nt, k_max, rt);
  return (int)cudaGetLastError();
}

// The ring's 16-byte copies of four lanes need a 16-byte aligned matrix and
// C in {32, 128}.
template <bool kAttrs>
int dispatch(int tri_chunk, const void* tri_mat_c, const void* attr16, const void* sids, const void* chunk_ids,
             const void* cnt, const void* d_t, const void* bt, void* t_out, void* idx_out, void* attr_out,
             int n_env, int t4, int nt, int k_max, int rt, void* stream) {
  if (rt <= 0 || (uintptr_t)tri_mat_c % 16 != 0) return (int)cudaErrorInvalidValue;
  switch (tri_chunk) {
    case 32:
      return launch<32, kAttrs>(tri_mat_c, attr16, sids, chunk_ids, cnt, d_t, bt, t_out, idx_out, attr_out, n_env,
                                t4, nt, k_max, rt, stream);
    case 128:
      return launch<128, kAttrs>(tri_mat_c, attr16, sids, chunk_ids, cnt, d_t, bt, t_out, idx_out, attr_out,
                                 n_env, t4, nt, k_max, rt, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Frustum-selected chunks: visits chunk_ids[env, tile, :cnt[env, tile]].
int raycast_fused_sel(const void* tri_mat_c, const void* sids,
                      const void* chunk_ids, const void* cnt, const void* d_t,
                      const void* bt, void* t_out, void* idx_out, int n_env,
                      int t4, int nt, int k_max, int rt, int tri_chunk,
                      void* stream) {
  if (chunk_ids == nullptr || cnt == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<false>(tri_chunk, tri_mat_c, nullptr, sids, chunk_ids, cnt, d_t, bt, t_out, idx_out, nullptr,
                         n_env, t4, nt, k_max, rt, stream);
}

// Every chunk of the scene in order.
int raycast_fused(const void* tri_mat_c, const void* sids, const void* d_t,
                  const void* bt, void* t_out, void* idx_out, int n_env,
                  int t4, int nt, int rt, int tri_chunk, void* stream) {
  return dispatch<false>(tri_chunk, tri_mat_c, nullptr, sids, nullptr, nullptr, d_t, bt, t_out, idx_out, nullptr,
                         n_env, t4, nt, 0, rt, stream);
}

// A tile's first cnt listed chunks, then the plane-exact epilogue.
int raycast_tilecull(const void* tri_mat_c, const void* attr16,
                     const void* sids, const void* chunk_ids, const void* cnt,
                     const void* d_t, const void* bt, void* t_out,
                     void* attr_out, int n_env, int t4, int nt, int k_max,
                     int rt, int tri_chunk, void* stream) {
  if (chunk_ids == nullptr || cnt == nullptr || attr16 == nullptr || k_max <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<true>(tri_chunk, tri_mat_c, attr16, sids, chunk_ids, cnt, d_t, bt, t_out, nullptr, attr_out,
                        n_env, t4, nt, k_max, rt, stream);
}

// The kernel's design at chunk size C (32 or 128), as ring_design reports
// it: the frustum-selected and every-chunk form, or with attrs the tile-cull
// form.
int raycast_fused_design(int C, int attrs, int* out) {
  const void* kernel = C == 32 ? (attrs ? (const void*)fused_raycast_kernel<32, true>
                                        : (const void*)fused_raycast_kernel<32, false>)
                               : (attrs ? (const void*)fused_raycast_kernel<128, true>
                                        : (const void*)fused_raycast_kernel<128, false>);
  return ring_design(kernel, ring_smem(C), out);
}

}  // extern "C"
