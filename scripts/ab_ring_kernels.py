#!/usr/bin/env python3
"""Times the closest-hit, max-pool backward and cull-mask kernels of two
checkouts of the port on the same inputs, in one run on one card.

    python3 scripts/ab_ring_kernels.py --roots PARENT . . PARENT [--check] [--set scan|bench|pool_cull|tilecull|all]

Each root is a checkout holding ``habitat_torch/``; each is run in its own
process, in the order given (parent, change, change, parent puts drift on
both sides). A process builds that checkout's kernels, generates the scenes
of ``chip_smoke.py`` and times with CUDA events, on each scene's reset:

- ``--set scan`` (the scan scene, 859,290 triangles):
  #4 ``raycast_exactsel_t`` (N=256, 128x128, chunklets of 32),
  #5 ``raycast_stream_t`` (the same reset, ``backend="stream"``, chunks of 256),
  #7 ``raycast_culled_t`` (N=32, 128x256 equirect, K=160 chunks of 256),
  #9 ``raycast_culled`` (#7's ids split into 320 chunks of 128);
- ``--set bench`` (the bench scenes and the mid-size scene):
  #1 ``raycast_fused_sel_t`` (bench reset, N=256, 128x128),
  #2 ``raycast_fused_t`` (mid-size reset, N=16, 128x128, 34 chunks of 128),
  #3 ``raycast_index_t`` (panoramic bench reset, N=256, 128x256 equirect;
  mid-size fisheye reset, N=16, 128x128),
  #8 ``raycast_index`` (the bench reset's rays, row-major features);
- ``--set pool_cull``: #11 ``max_pool_3x3s2_bwd`` on the bench update's
  minibatch, (4096, 32, 64, 64) bf16 channels-last ReLU noise (also on the
  panoramic minibatch (4096, 32, 64, 128) bf16 and the bench one in
  float32), and #6 ``cullmask_t`` on the scan reset's 384-slot head (the
  level-1 survivors of ``select_chunklets_exact``, N=256, 16 tiles);
- ``--set tilecull``: #10 ``raycast_tilecull_t`` on #1's bench reset
  inputs (N=256, 128x128, chunks of 32) with ``attr16_table`` of the bench
  pack.

With ``--check`` each kernel is also held against its plain version on the
card (t and winner equal on every ray, except the stream kernels' rounding
case: a ray whose plain hit is nearer, counted; #11 bit-equal; #6 bit-equal
on the gated slots and zero beyond; #10 t and all 16 rows equal), #9
against #7 bit for bit and #8
against #3 on the same rays (winner and t equal but on margin boundaries,
counted). Prints one JSON line per root and the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

SCAN = dict(tess=0.04, n_clutter=40, cells=(0.08, 0.25, 0.6), bands=(1.2, 3.0, 8.0))


def cuda_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scan_runs(rk, rc, dev, call):
    """The scan route's kernels on the scan scene's resets."""
    import numpy as np
    import torch

    from habitat_torch.core.batched_env import BatchedEnv
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.core.registry import registry
    from habitat_torch.datasets.pointnav import generate_pointnav_episode
    from habitat_torch.sims.procedural import build_lod_scene, generate_scan_apartment

    scene = generate_scan_apartment(0, tess=SCAN["tess"], n_clutter=SCAN["n_clutter"])
    lod = build_lod_scene(scene, cells=SCAN["cells"], bands=SCAN["bands"])
    lod.scene_id = scene.scene_id
    rng = np.random.default_rng(0)
    pairs = [p for p in (generate_pointnav_episode(scene, str(i), rng) for i in range(16)) if p is not None]
    env = make_nav_env([lod], [p[0] for p in pairs], num_envs=256, max_episode_steps=500,
                       precomputed_fields={e.episode_id: f for (e, f) in pairs}, sensor_specs=sensors(SIZE))
    pano_env = BatchedEnv(env.pack, env.table, env.order[:32].cpu().numpy(),
                          [registry.get_sensor(n)(c) for n, c in sensors(PANO, "Equirectangular")], env.measures,
                          env.actions, device=dev, max_episode_steps=500)
    culled = call(pano_env, PANO, projection="equirect")
    ids, split = culled[1][2], culled[2]["tri_chunk"] // 128
    ids128 = (ids[..., None] * split + torch.arange(split, dtype=torch.int32, device=dev)).reshape(*ids.shape[:2], -1)
    origins = culled[1][4][:, :, 3:6].transpose(2, 3).reshape(culled[3].shape)
    c9 = (rk.raycast_culled, (env.pack.tri_mat, env.pack.tri_attr, ids128.contiguous(), culled[1][3], None, None),
          dict(ray_tile=1024, tri_chunk=128, features=rc.ray_features(origins, culled[3])), None)
    runs = [("raycast_exactsel_t", call(env, SIZE), 20), ("raycast_stream_t", call(env, SIZE, backend="stream"), 3),
            ("raycast_culled_t", culled, 5), ("raycast_culled", c9, 5)]
    design = {}
    if hasattr(rk, "stream_design"):
        design = dict(raycast_stream=rk.stream_design(),
                      raycast_culled_t=rk.culled_design(culled[2]["tri_chunk"], ids.shape[2]),
                      raycast_culled=rk.culled_design(128, ids128.shape[2], row_major=True))
    return runs, design


def bench_runs(rk, rc, dev, call):
    """The frustum-selected, every-chunk and index kernels on the bench and
    mid-size scenes' resets."""
    import torch

    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav

    scenes, episodes, fields = make_procedural_pointnav(num_scenes=4, episodes_per_scene=16, seed=0)
    kw = dict(num_envs=256, precomputed_fields=fields, max_episode_steps=500)
    env = make_nav_env(scenes, episodes, sensor_specs=sensors(SIZE), **kw)
    pano_env = make_nav_env(scenes, episodes, sensor_specs=sensors(PANO, "Equirectangular"), **kw)
    mscenes, meps, mfields = make_procedural_pointnav(num_scenes=1, episodes_per_scene=4, seed=0, extent=30.0,
                                                      scene_kw=dict(n_clutter=420))
    mid_env = make_nav_env(mscenes, meps, num_envs=16, precomputed_fields=mfields, max_episode_steps=500,
                           sensor_specs=sensors(SIZE))
    st, _ = env.reset_fn()
    cam = st.pos + torch.tensor(CAM, device=dev)
    dirs = rc.world_rays(st.yaw, st.pitch, 90.0, **SIZE)
    origins = cam[:, None, :].expand(-1, dirs.shape[1], -1)
    sid = env._make_ctx(st).sid.to(torch.int32)
    # #8 on the bench reset's rays, and #3 on the same rays to compare with
    index_rm = (rk.raycast_index, (env.pack.tri_mat, sid, rc.ray_features(origins, dirs)), dict(ray_tile=2048), None)
    index_t = (rk.raycast_index_t, (env.pack.tri_mat, sid, rc.ray_features_t(origins, dirs, 2048)),
               dict(ray_tile=2048), None)
    runs = [("raycast_fused_sel_t", call(env, SIZE), 50), ("raycast_fused_t", call(mid_env, SIZE), 20),
            ("raycast_index_t", call(pano_env, PANO, projection="equirect"), 20),
            ("raycast_index_t", call(mid_env, SIZE, projection="fisheye"), 10),
            ("raycast_index", index_rm, 20)]
    design = {}
    if hasattr(rk, "index_design"):
        design = dict(raycast_index_t=rk.index_design(128), raycast_index=rk.index_design(128, row_major=True),
                      raycast_fused_sel_t=rk.fused_design(32), raycast_fused_t=rk.fused_design(128))
    return runs, design, index_t


def tilecull_runs(rk, call):
    """The tile-cull kernel on the frustum-selected kernel's bench reset
    inputs."""
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav

    scenes, episodes, fields = make_procedural_pointnav(num_scenes=4, episodes_per_scene=16, seed=0)
    env = make_nav_env(scenes, episodes, num_envs=256, precomputed_fields=fields, max_episode_steps=500,
                       sensor_specs=sensors(SIZE))
    _, (gm, sids, ids, cnt, d_t, Bt), kwargs, _ = call(env, SIZE)
    a16 = rk.attr16_table(env.pack.tri_attr, env.pack.tri_v0, tri_chunk=kwargs["tri_chunk"])
    runs = [("raycast_tilecull_t", (rk.raycast_tilecull_t, (gm, a16, ids, cnt, sids, d_t, Bt), kwargs, None), 50)]
    design = dict(raycast_tilecull_t=rk.tilecull_design(32)) if hasattr(rk, "tilecull_design") else {}
    return runs, design


def pool_cull_rows(rk, dev, check):
    """#11 on the update's minibatches and #6 on the scan reset's head:
    {label: row}, and the kernels' designs where the checkout reports them."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import generate_pointnav_episode
    from habitat_torch.ops import pool
    from habitat_torch.ops import raycast as rc
    from habitat_torch.sims.procedural import build_lod_scene, generate_scan_apartment

    rows, design = {}, {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, shape, dtype in (("max_pool_3x3s2_bwd", (4096, 32, 64, 64), torch.bfloat16),
                                ("max_pool_3x3s2_bwd pano", (4096, 32, 64, 128), torch.bfloat16),
                                ("max_pool_3x3s2_bwd f32", (4096, 32, 64, 64), torch.float32)):
        x = torch.relu(torch.randn(shape, generator=gen, device=dev)).to(dtype).contiguous(memory_format=torch.channels_last)
        y = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2).contiguous(memory_format=torch.channels_last)
        dy = torch.randn(y.shape, generator=gen, device=dev).to(dtype).contiguous(memory_format=torch.channels_last)
        before = pool.max_pool_3x3s2_bwd.launches
        gx = pool.max_pool_3x3s2_bwd(x, y, dy)
        torch.cuda.synchronize()
        if pool.max_pool_3x3s2_bwd.launches != before + 1:
            raise RuntimeError(f"{label} did not launch its kernel")
        row = dict(ms=cuda_ms(lambda: pool.max_pool_3x3s2_bwd(x, y, dy), 20))
        row["tb_per_s"] = 2 * (x.numel() + y.numel()) * x.element_size() / (row["ms"] * 1e-3) / 1e12
        if check:
            row["elements_differing"] = int((gx != pool.max_pool_3x3s2_bwd.plain(x, y, dy)).sum())
            if row["elements_differing"]:
                raise RuntimeError(f"{label}: {row}")
        rows[label] = row
        del x, y, dy, gx
        torch.cuda.empty_cache()
    if hasattr(pool, "maxpool_bwd_design"):
        design.update(max_pool_3x3s2_bwd=pool.maxpool_bwd_design(torch.bfloat16),
                      max_pool_3x3s2_bwd_f32=pool.maxpool_bwd_design(torch.float32))

    scene = generate_scan_apartment(0, tess=SCAN["tess"], n_clutter=SCAN["n_clutter"])
    lod = build_lod_scene(scene, cells=SCAN["cells"], bands=SCAN["bands"])
    lod.scene_id = scene.scene_id
    rng = np.random.default_rng(0)
    pairs = [p for p in (generate_pointnav_episode(scene, str(i), rng) for i in range(16)) if p is not None]
    env = make_nav_env([lod], [p[0] for p in pairs], num_envs=256, max_episode_steps=500,
                       precomputed_fields={e.episode_id: f for (e, f) in pairs}, sensor_specs=sensors(SIZE))
    pack = env.pack
    st, _ = env.reset_fn()
    sid, cam = env._make_ctx(st).sid.to(torch.int32), (st.pos + torch.tensor(CAM, device=dev)).float()
    _, _, _, planes, _ = rc.block_constants(90.0, SIZE["height"], SIZE["width"], dev)
    dirs = rc.to_blocks(rc.world_rays(st.yaw, st.pitch, 90.0, **SIZE), **SIZE)
    R = SIZE["height"] * SIZE["width"]
    ids0, cnt0 = rc.select_chunks(pack.chunk_bounds[sid.long()], cam[:, None, :].expand(-1, R, -1), dirs, 1024, 320,
                                  with_cnt=True)
    head, cntk = rc.select_chunklets_exact(
        pack.tri_v0, pack.tri_e1, pack.tri_e2, pack.tri_valid, pack.chunklet_ab32, sid, cam, st.yaw, st.pitch, planes,
        ids0, cnt0, parent_c=pack.tri_mat.shape[3] // pack.chunk_bounds.shape[1], c=32, k_final=384)
    nw = torch.einsum("nij,kpj->nkpi", rc.view_rotation_matrix(st.yaw, st.pitch), planes).contiguous()
    args = (pack.tri_verts16, sid, head, cntk, nw, cam)
    before = rk.cullmask_t.launches
    mask = rk.cullmask_t(*args)
    torch.cuda.synchronize()
    if rk.cullmask_t.launches != before + 1:
        raise RuntimeError("cullmask_t did not launch its kernel")
    gate = torch.arange(head.shape[2], device=dev) < cntk[..., None]
    nch = pack.tri_verts16.shape[1] // 32
    cid = (head & ((1 << 18) - 1)).clamp(max=nch - 1).long()
    env_rows = torch.arange(head.shape[0], device=dev)[:, None, None] * nch + cid  # (env, chunklet) pairs
    row = dict(ms=cuda_ms(lambda: rk.cullmask_t(*args), 50), gated_slots_per_tile_mean=cntk.float().mean().item(),
               gathered_row_bytes=int(gate.sum()) * 2048,
               distinct_per_env_row_bytes=int(torch.unique(env_rows[gate]).numel()) * 2048)
    if check:
        ref = rk.cullmask_t.plain(*args)
        row["gated_differing"] = int((mask[gate] != ref[gate]).sum())
        row["ungated_nonzero"] = int((mask[~gate] != 0).sum())
        if row["gated_differing"] or row["ungated_nonzero"]:
            raise RuntimeError(f"cullmask_t: {row}")
    rows["cullmask_t"] = row
    if hasattr(rk, "cullmask_design"):
        design["cullmask_t"] = rk.cullmask_design()
    return rows, design


CAM = (0.0, 1.25, 0.0)  # the camera above the agent's position
SIZE = dict(height=128, width=128)
PANO = dict(height=128, width=256)
LABELS = {  # run order within a set -> the row's name in the output
    "bench": ("raycast_fused_sel_t", "raycast_fused_t mid", "raycast_index_t pano", "raycast_index_t mid fisheye",
              "raycast_index"),
    "scan": ("raycast_exactsel_t", "raycast_stream_t", "raycast_culled_t", "raycast_culled"),
    "tilecull": ("raycast_tilecull_t",),
}


def sensors(hw, kind=""):
    return ((f"HabitatSim{kind}DepthSensor", hw), (f"HabitatSim{kind}RGBSensor", hw),
            ("PointGoalWithGPSCompassSensor", None))


def one(root, check, sets):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from habitat_torch.ops import cuda_build
    from habitat_torch.ops import raycast as rc
    from habitat_torch.ops import raycast_kernels as rk

    if not rk.__file__.startswith(root):
        raise RuntimeError(f"imported {rk.__file__}, not from {root}")
    sources = {"scan": ("raycast_stream", "raycast_general"), "bench": ("raycast_fused", "raycast_general"),
               "pool_cull": ("maxpool_bwd", "cullmask"), "tilecull": ("raycast_fused",)}
    built = cuda_build.build(tuple(sorted({n for k in sets for n in sources[k]})))
    dev = torch.device("cuda")

    def call(e, hw, **kw):
        st, _ = e.reset_fn()
        cam = st.pos + torch.tensor(CAM, device=dev)
        return rc.closest_hit_call(e.pack, e._make_ctx(st).sid, cam, st.yaw, st.pitch, **hw, **kw)

    out = dict(root=root, ptxas={k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                                 for k, (_, v) in built.items()}, design={})
    runs, index_t_on_rays8, pool_cull = [], None, {}
    for name in sets:
        if name == "pool_cull":
            pool_cull, design = pool_cull_rows(rk, dev, check)
        elif name == "scan":
            got, design = scan_runs(rk, rc, dev, call)
        elif name == "tilecull":
            got, design = tilecull_runs(rk, call)
        else:
            got, design, index_t_on_rays8 = bench_runs(rk, rc, dev, call)
        if name in LABELS:
            runs += [(label, *run) for label, run in zip(LABELS[name], got)]
        out["design"].update(design)
    results = {}
    for label, name, (kernel, args, kwargs, _), reps in runs:
        if kernel is not getattr(rk, name):
            raise RuntimeError(f"{label}: the route took {kernel.__name__}")
        before = kernel.launches
        got = kernel(*args, **kwargs)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise RuntimeError(f"{label} did not launch its kernel")
        row = dict(ms=cuda_ms(lambda: kernel(*args, **kwargs), reps))
        if check:
            stream = name in ("raycast_exactsel_t", "raycast_stream_t")
            tested = dict(block=0, warp=0)
            t0 = time.perf_counter()
            ref = kernel.plain(*args, **kwargs, **(dict(tested=tested) if stream else {}))
            torch.cuda.synchronize()
            row["plain_s"] = time.perf_counter() - t0
            if stream:  # the early stop's work on these inputs at the kernel's granularity
                n_rays = ref[0].numel()
                row.update(staged_per_block_mean=tested["block"] / (n_rays / getattr(rk, "STREAM_BLOCK_RAYS", 256)),
                           computed_per_warp_mean=tested["warp"] / (n_rays / getattr(rk, "STREAM_WARP_RAYS", 32)))
            (t_k, w_k), (t_p, w_p) = got, ref
            differ = t_k != t_p
            if name == "raycast_culled_t":  # attributes (N, 8, R)
                differ |= (w_k != w_p).any(1)
            elif name == "raycast_culled":  # (N, R, 8)
                differ |= (w_k != w_p).any(2)
            elif name == "raycast_tilecull_t":  # (N, nt, 16, Rt)
                differ |= (w_k != w_p).any(2).reshape(differ.shape)
            else:
                differ |= w_k != w_p
            # the stream kernels' rounding case: the plain version, testing every slot, is nearer
            nearer = differ & (t_p < t_k) if stream else differ & False
            row.update(rays=t_k.numel(), rays_differing=int(differ.sum()), nearer_in_plain_rays=int(nearer.sum()))
            if int((differ & ~nearer).sum()):
                raise RuntimeError(f"{label}: {row}")
        results[label] = (row, got)
    if check and "scan" in sets:
        t7, a7 = results["raycast_culled_t"][1]
        t9, a9 = results["raycast_culled"][1]
        if not (torch.equal(t9, t7) and torch.equal(a9, a7.transpose(1, 2))):
            raise RuntimeError("raycast_culled differs from raycast_culled_t")
    if check and "bench" in sets:  # #8 against #3 on the same rays: the margins differ on boundaries only
        kernel, args, kwargs, _ = index_t_on_rays8
        (t3, i3), (t8, i8) = kernel(*args, **kwargs), results["raycast_index"][1]
        results["raycast_index"][0]["rays_differing_from_index_t"] = int(((t3 != t8) | (i3 != i8)).sum())
    out["kernels"] = {**{k: v[0] for k, v in results.items()}, **pool_cull}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--set", choices=("scan", "bench", "pool_cull", "tilecull", "all"), default="all")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_ring_kernels: no CUDA device", file=sys.stderr)
        return 2
    if a.one:
        print(json.dumps(one(a.one, a.check, ("bench", "scan", "pool_cull", "tilecull") if a.set == "all" else (a.set,))),
              flush=True)
        return 0
    for root in a.roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", root, "--set", a.set] + (["--check"] if a.check else [])
        subprocess.run(cmd, check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
