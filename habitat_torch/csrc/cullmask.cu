// The exact cull's per-triangle test for the nearest survivors of a screen
// tile, one thread per (head slot, triangle), for sm_90a.
//
// Replaces the TPU kernel of habitat_tpu/ops/raycast_pallas.py:
//   cullmask <- cullmask_pallas_t / _cullmask_kernel_t
//
// What it computes, per (env, tile, head slot below cntk, triangle of the
// slot's 32-triangle chunklet): pass = valid and not, for any of the tile's
// four inward frustum planes n, all three vertices outside it:
//   d0 = n.(v0 - cam) < eps  and  d0 + n.e1 < eps  and  d0 + n.e2 < eps
// (eps = -1e-3: a triangle is dropped only when it is clearly outside).
// The TPU kernel evaluates the twelve conditions as one block-diagonal
// (U, 512) x (512, 512) matrix product against per-tile thresholds
// eps + cam.n, a shape chosen for its matrix unit; this kernel computes the
// direct form that select_chunklets_exact's PyTorch branch computes, each
// product and sum rounded separately and in the same order, so the two
// agree bit for bit.
//
// What bounds it on an H100: bytes. Each thread reads one 64-byte row of
// verts16 (a warp reads its chunklet's 2 KB contiguously) and writes 4
// bytes, for about 60 FP32 operations. Slots at or beyond cntk write 0.
//
// Layouts (row-major, float32 unless noted):
//   verts16 (S, T, 16)      rows [v0(3) | e1(3) | e2(3) | pad(6) | valid]
//   sids    (N,)            int32 scene per env
//   head    (N, nt, ka)     int32 packed slots (dmin_cm << 18) | chunklet id
//   cntk    (N, nt)         int32 slots to test per (env, tile)
//   nw      (N, nt, 4, 3)   world-frame inward plane normals of the tile
//   cam_pos (N, 3)
//   out     (N, nt, ka, 32)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;  // triangles per chunklet = threads per slot
constexpr int kSlots = 8;  // head slots per block
constexpr int kIdMask = (1 << 18) - 1;

__device__ __forceinline__ float dot3(float x, float y, float z, const float* n) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, n[0]), __fmul_rn(y, n[1])),
                   __fmul_rn(z, n[2]));
}

__global__ void __launch_bounds__(kC* kSlots) cullmask_kernel(
    const float* __restrict__ verts16, const int* __restrict__ sids,
    const int* __restrict__ head, const int* __restrict__ cntk,
    const float* __restrict__ nw, const float* __restrict__ cam_pos,
    float* __restrict__ out, int nt, int ka, int nch, float eps) {
  const int et = blockIdx.x;  // env * nt + tile
  const int env = et / nt;
  const int slot = blockIdx.y * kSlots + threadIdx.y;
  if (slot >= ka) return;
  const size_t o = ((size_t)et * ka + slot) * kC + threadIdx.x;
  if (slot >= cntk[et]) {
    out[o] = 0.f;
    return;
  }
  const int cid = min(head[(size_t)et * ka + slot] & kIdMask, nch - 1);
  const float4* row = reinterpret_cast<const float4*>(
      verts16 + (((size_t)sids[env] * nch + cid) * kC + threadIdx.x) * 16);
  const float4 a = row[0];  // v0.xyz, e1.x
  const float4 b = row[1];  // e1.yz, e2.xy
  const float4 c = row[2];  // e2.z, pad
  const float valid = row[3].w;
  const float* cam = cam_pos + (size_t)env * 3;
  const float rx = __fsub_rn(a.x, cam[0]);
  const float ry = __fsub_rn(a.y, cam[1]);
  const float rz = __fsub_rn(a.z, cam[2]);
  bool out_any = false;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float* n = nw + ((size_t)et * 4 + p) * 3;
    const float d0 = dot3(rx, ry, rz, n);
    const float d1 = __fadd_rn(d0, dot3(a.w, b.x, b.y, n));
    const float d2 = __fadd_rn(d0, dot3(b.z, b.w, c.x, n));
    out_any = out_any || (d0 < eps && d1 < eps && d2 < eps);
  }
  out[o] = (!out_any && valid > 0.5f) ? 1.f : 0.f;
}

}  // namespace

extern "C" {

int cullmask(const void* verts16, const void* sids, const void* head,
             const void* cntk, const void* nw, const void* cam_pos, void* out,
             int n_env, int nt, int ka, int nch, float eps, void* stream) {
  if (n_env <= 0 || nt <= 0 || ka <= 0 || nch <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kC, kSlots);
  const dim3 grid(n_env * nt, (ka + kSlots - 1) / kSlots);
  cullmask_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)verts16, (const int*)sids, (const int*)head,
      (const int*)cntk, (const float*)nw, (const float*)cam_pos, (float*)out,
      nt, ka, nch, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
