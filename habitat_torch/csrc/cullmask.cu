// The exact cull's per-triangle test for the nearest survivors of a screen
// tile, one block per (env, tile), for sm_90a.
//
// Replaces the TPU kernel of habitat_tpu/ops/raycast_pallas.py:
//   cullmask <- cullmask_pallas_t / _cullmask_kernel_t
//
// What it computes, per (env, tile, head slot below cntk, triangle of the
// slot's 32-triangle chunklet): pass = valid and not, for any of the tile's
// four inward frustum planes n, all three vertices outside it:
//   d0 = n.(v0 - cam) < eps  and  d0 + n.e1 < eps  and  d0 + n.e2 < eps
// (eps = -1e-3: a triangle is dropped only when it is clearly outside);
// slots at or beyond cntk hold 0.
// The TPU kernel evaluates the twelve conditions as one block-diagonal
// (U, 512) x (512, 512) matrix product against per-tile thresholds
// eps + cam.n, a shape chosen for its matrix unit; this kernel computes the
// direct form that select_chunklets_exact's PyTorch branch computes, each
// product and sum rounded separately and in the same order, so the two
// agree bit for bit.
//
// What bounds it on an H100: from device memory, bytes. The output (N, nt,
// ka, 32) float32 is most of them (201 MB of ~224 on the scan reset's
// 384-slot head); the rest are the distinct 2 KB chunklet rows the gated
// slots read (16 MB), the head and the planes. But every gated slot reads its
// row through L2: 1.48 GB on that head, which L2 serves at about 7 TB/s, and
// that sets the pace (on an H100 the zeros alone take 0.06 ms of 0.22). The tiles
// of an env list the same rows 3.2 times over; sorting an env's slots by
// chunklet in shared memory, to read each row once, cost more than it saved.
// A block per (head slot group), as before, reloaded the tile's count,
// scene, camera and twelve plane floats in every thread and spent full
// blocks storing the zeros of ungated slots 4 bytes a lane.
//
// The design: one block of kWarps warps per (env, tile). Each thread loads
// the tile's planes and camera once. The ungated tail [cntk, ka) is one
// contiguous range, zeroed with 16-byte stores by the whole block. Warps
// take the gated slots [0, cntk) in turn (slot s to warp s % kWarps): a lane
// loads the head entry of one of the warp's next 32 slots, which the warp
// then shares by shuffle, and per slot the lane is a triangle whose 64-byte
// row is four 16-byte loads (the warp's 2 KB contiguous); kUnroll slots'
// rows are in flight at once.
//
// Layouts (row-major, float32 unless noted):
//   verts16 (S, T, 16)      rows [v0(3) | e1(3) | e2(3) | pad(6) | valid]
//   sids    (N,)            int32 scene per env
//   head    (N, nt, ka)     int32 packed slots (dmin_cm << 18) | chunklet id
//   cntk    (N, nt)         int32 slots to test per (env, tile)
//   nw      (N, nt, 4, 3)   world-frame inward plane normals of the tile
//   cam_pos (N, 3)
//   out     (N, nt, ka, 32), 16-byte aligned

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;  // triangles per chunklet = lanes per slot
constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = kC * kWarps;
constexpr int kUnroll = 2;  // slots a warp has in flight
constexpr int kIdMask = (1 << 18) - 1;

__device__ __forceinline__ float dot3(float x, float y, float z, const float* n) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, n[0]), __fmul_rn(y, n[1])),
                   __fmul_rn(z, n[2]));
}

__global__ void __launch_bounds__(kThreads) cullmask_kernel(
    const float* __restrict__ verts16, const int* __restrict__ sids,
    const int* __restrict__ head, const int* __restrict__ cntk,
    const float* __restrict__ nw, const float* __restrict__ cam_pos,
    float* __restrict__ out, int nt, int ka, int nch, float eps) {
  const int et = blockIdx.x;  // env * nt + tile
  const int env = et / nt;
  const int lane = threadIdx.x & (kC - 1), warp = threadIdx.x / kC;
  const int cnt = min(max(__ldg(cntk + et), 0), ka);
  float* o = out + (size_t)et * ka * kC;
  // the ungated tail, 16 bytes a store
  float4* tail = reinterpret_cast<float4*>(o + (size_t)cnt * kC);
  for (int i = threadIdx.x; i < (ka - cnt) * (kC / 4); i += kThreads)
    __stcs(tail + i, make_float4(0.f, 0.f, 0.f, 0.f));
  if (warp >= cnt) return;
  float n[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) n[k] = __ldg(nw + (size_t)et * 12 + k);
  const float cx = __ldg(cam_pos + env * 3), cy = __ldg(cam_pos + env * 3 + 1),
              cz = __ldg(cam_pos + env * 3 + 2);
  const float4* rows = reinterpret_cast<const float4*>(verts16) +
                       ((size_t)__ldg(sids + env) * nch * kC + lane) * 4;
  const int* h = head + (size_t)et * ka;
  // this warp's slots warp, warp + kWarps, ...: 32 at a time
  for (int s0 = warp; s0 < cnt; s0 += 32 * kWarps) {
    const int mine = s0 + lane * kWarps;
    const int cid = mine < cnt ? min(__ldg(h + mine) & kIdMask, nch - 1) : 0;
    const int m = min(32, (cnt - s0 + kWarps - 1) / kWarps);
    for (int j = 0; j < m; j += kUnroll) {
      float4 a[kUnroll], b[kUnroll], c[kUnroll];
      float valid[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4* row = rows + (size_t)__shfl_sync(0xffffffffu, cid, min(j + u, m - 1)) * kC * 4;
        a[u] = __ldg(row);      // v0.xyz, e1.x
        b[u] = __ldg(row + 1);  // e1.yz, e2.xy
        c[u] = __ldg(row + 2);  // e2.z, pad
        valid[u] = __ldg(reinterpret_cast<const float*>(row) + 15);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u >= m) break;
        const float rx = __fsub_rn(a[u].x, cx);
        const float ry = __fsub_rn(a[u].y, cy);
        const float rz = __fsub_rn(a[u].z, cz);
        bool out_any = false;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float d0 = dot3(rx, ry, rz, n + 3 * p);
          const float d1 = __fadd_rn(d0, dot3(a[u].w, b[u].x, b[u].y, n + 3 * p));
          const float d2 = __fadd_rn(d0, dot3(b[u].z, b[u].w, c[u].x, n + 3 * p));
          out_any = out_any || (d0 < eps && d1 < eps && d2 < eps);
        }
        o[(size_t)(s0 + (j + u) * kWarps) * kC + lane] = (!out_any && valid[u] > 0.5f) ? 1.f : 0.f;
      }
    }
  }
}

}  // namespace

extern "C" {

int cullmask(const void* verts16, const void* sids, const void* head,
             const void* cntk, const void* nw, const void* cam_pos, void* out,
             int n_env, int nt, int ka, int nch, float eps, void* stream) {
  if (n_env <= 0 || nt <= 0 || ka <= 0 || nch <= 0 || (uintptr_t)out % 16 || (uintptr_t)verts16 % 16)
    return (int)cudaErrorInvalidValue;
  cullmask_kernel<<<n_env * nt, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)verts16, (const int*)sids, (const int*)head,
      (const int*)cntk, (const float*)nw, (const float*)cam_pos, (float*)out,
      nt, ka, nch, eps);
  return (int)cudaGetLastError();
}

// The kernel's design: out = {triangles per slot, warps per block, slots in
// flight per warp, threads per block, registers per thread, local (spilled)
// bytes per thread, static shared bytes, blocks per SM}.
int cullmask_design(int* out) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, (const void*)cullmask_kernel);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)cullmask_kernel, kThreads, 0);
  if (err) return err;
  const int v[8] = {kC, kWarps, kUnroll, kThreads, attr.numRegs, (int)attr.localSizeBytes,
                    (int)attr.sharedSizeBytes, blocks};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
