#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (habitat_torch) runs on a GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100 and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build   nvcc compiles every CUDA source of the port (one per source, all
           started together) into habitat_torch/build/.
2. kernels each kernel's wrapper runs on the card at the shapes the render
           path gives it and is held against its plain PyTorch version on the
           same inputs (the frustum-selected kernel on the bench reset, the
           every-chunk kernel on the mid-size route's reset and on a
           synthetic 8192-triangle pack): hit/miss agreement >= 0.9999, winner-id agreement
           >= 0.999 (shared-edge near-ties), |dt| < 5e-3 m where the winner
           is the same. Timed with CUDA events beside its plain version and
           its bound on this card.
3. paths   the main path: the bench PointNav configuration (4 procedural
           scenes, 64 episodes, N=256 envs, 128x128 depth+RGB+pointgoal,
           resnet18 base 32 / 16 groups + LSTM-512, 4 actions, T=32) with
           weights from torch.manual_seed(0): reset, one warm-up rollout and
           ROLLOUTS timed rollouts through PPOLearner.collect_rollout (median
           and range of their env-steps/s), per-layer times, and one rollout
           under torch.profiler (device kernel time, idle share, launches,
           top kernels). Then the mid-size-scene route (one 4226-triangle
           scene padded to 4352, N=16, T=4), which renders through the
           every-chunk kernel. Launch counters are zeroed just before each
           path and read just after; every render of a path must have
           launched its kernel.
4. check   env + render + policy on the card against the same code on the
           CPU (plain kernel versions) on a small input.

Prints the kernels' JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_FP32_FLOPS = 67e12  # published dense float32 peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12  # published HBM3 rate
# FP32 operations per ray-triangle test: 4 dots of length 10 (40 FMAs = 80
# flops), the margin (4 mul, 2 sub, 1 mul + 1 sub, 1 sub, 4 min, 1 compare)
# and the fold compare
FLOPS_PER_RAY_TRI = 95
# per ray: 10 features of 4 products and 3 sums
FLOPS_PER_RAY = 70

BENCH = dict(num_envs=256, height=128, width=128, num_steps=32)
MID = dict(num_envs=16, num_steps=4, extent=30.0, n_clutter=420)
ROLLOUTS = 5  # timed bench rollouts after the warm-up one


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def device_us(evt):
    """A profiler entry's own device time in microseconds (the attribute's
    name differs across PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def compare_kernel(name, kernel, args, kwargs, n_tests, reps=50, plain_reps=3):
    """Kernel vs its plain version on the same card inputs; times both and
    works out the bound from this call's inputs and survivor count."""
    import torch

    before = kernel.launches
    t_k, i_k = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        fail(f"{name}: wrapper did not launch its kernel")
    t_p, i_p = kernel.plain(*args, **kwargs)
    hit_k, hit_p = i_k >= 0, i_p >= 0
    hit_agree = (hit_k == hit_p).float().mean().item()
    both = hit_k & hit_p
    idx_agree = (i_k[both] == i_p[both]).float().mean().item()
    same = both & (i_k == i_p)
    max_err = (t_k[same] - t_p[same]).abs().max().item()
    if not (hit_agree >= 0.9999 and idx_agree >= 0.999 and max_err < 5e-3):
        fail(f"{name}: hit {hit_agree} idx {idx_agree} |dt| {max_err}")
    ms = cuda_ms(lambda: kernel(*args, **kwargs), reps)
    plain_ms = cuda_ms(lambda: kernel.plain(*args, **kwargs), plain_reps, warmup=1)
    n_rays = t_k.numel()
    bytes_moved = sum(a.numel() * a.element_size() for a in args) + 8 * n_rays
    flops = n_tests * FLOPS_PER_RAY_TRI + n_rays * FLOPS_PER_RAY
    t_bytes, t_ops = bytes_moved / H100_BYTES_PER_S * 1e3, flops / H100_FP32_FLOPS * 1e3
    return dict(
        name=name, route="cuda", source="habitat_torch/csrc/raycast_fused.cu",
        max_abs_err=max_err, hit_agree=hit_agree, idx_agree=idx_agree,
        ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes > t_ops else "operations",
        library_ms=None, ray_tri_tests=n_tests, hit_fraction=hit_k.float().mean().item(),
    )


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "habitat_torch")):
        print("chip_smoke: run from a checkout of the repository (habitat_torch/ missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav
    from habitat_torch.models.policy import make_pointnav_resnet_policy
    from habitat_torch.ops import raycast as rc
    from habitat_torch.ops import raycast_kernels as rk

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gpu = gpu_name_and_power()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} card {gpu}")

    # ---- 1. build -------------------------------------------------------
    secs, ptxas = rk.build()  # the port's one CUDA source
    log(f"[build] raycast_fused.cu {secs:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")

    # ---- scenes and envs (host generation counts as set-up) ------------
    sensors = (
        ("HabitatSimDepthSensor", {"height": BENCH["height"], "width": BENCH["width"]}),
        ("HabitatSimRGBSensor", {"height": BENCH["height"], "width": BENCH["width"]}),
        ("PointGoalWithGPSCompassSensor", None),
    )
    scenes, episodes, fields = make_procedural_pointnav(num_scenes=4, episodes_per_scene=16, seed=0)
    env = make_nav_env(
        scenes, episodes, num_envs=BENCH["num_envs"], precomputed_fields=fields,
        max_episode_steps=500, sensor_specs=sensors,
    )
    torch.manual_seed(0)
    policy = make_pointnav_resnet_policy(len(env.actions), backbone="resnet18", hidden_size=512)
    mscenes, meps, mfields = make_procedural_pointnav(
        num_scenes=1, episodes_per_scene=4, seed=0, extent=MID["extent"],
        scene_kw=dict(n_clutter=MID["n_clutter"]),
    )
    mid_env = make_nav_env(
        mscenes, meps, num_envs=MID["num_envs"], precomputed_fields=mfields,
        max_episode_steps=500, sensor_specs=sensors,
    )
    log(f"[setup] bench pack {tuple(env.pack.tri_mat.shape)}, mid pack {tuple(mid_env.pack.tri_mat.shape)}, "
        f"{time.perf_counter() - t_start:.1f} s")

    # ---- 2. kernels -------------------------------------------------------
    def reset_render_call(e):
        """The closest-hit call of an env's reset render: its first render inputs."""
        st, _ = e.reset_fn()
        cam = st.pos + torch.tensor([0.0, 1.25, 0.0], device=dev)
        return rc.closest_hit_call(
            e.pack, e._make_ctx(st).sid, cam, st.yaw, st.pitch,
            height=BENCH["height"], width=BENCH["width"],
        )

    kernel, args, kwargs, _ = reset_render_call(env)
    if kernel is not rk.raycast_fused_sel_t:
        fail("bench scenes should take the frustum-selected kernel")
    cnt = args[3]
    n_tests = int(cnt.sum().item()) * 32 * kwargs["ray_tile"]
    sel = compare_kernel("raycast_fused_sel_t", kernel, args, kwargs, n_tests)
    sel["replaces"] = "habitat_tpu/ops/raycast_pallas.py:623"
    sel["survivor_chunks_mean"] = cnt.float().mean().item()

    # every-chunk kernel at the mid-size route's shape, on its reset render
    kernel, args, kwargs, _ = reset_render_call(mid_env)
    if kernel is not rk.raycast_fused_t:
        fail("the mid-size scene should take the every-chunk kernel")
    n_tests = MID["num_envs"] * BENCH["height"] * BENCH["width"] * mid_env.pack.tri_attr.shape[1]
    every = compare_kernel("raycast_fused_t", kernel, args, kwargs, n_tests, reps=20, plain_reps=1)
    every["replaces"] = "habitat_tpu/ops/raycast_pallas.py:482"

    # and on a synthetic 8192-triangle pack, N=8 (twice the mid scene's chunks)
    g = torch.Generator().manual_seed(0)
    T = 8192
    v0 = torch.rand(T, 3, generator=g) * 8 - 4
    e1, e2 = torch.randn(T, 3, generator=g) * 0.4, torch.randn(T, 3, generator=g) * 0.4
    tm = torch.from_numpy(rc.build_tri_matrix(v0.numpy(), e1.numpy(), e2.numpy(), torch.ones(T, dtype=torch.bool).numpy()))
    gm = rc.group_tri_mat(tm[None], 128).contiguous().to(dev)
    n = 8
    pos = (torch.rand(n, 3, generator=g) - 0.5).to(dev)
    yaw = (torch.rand(n, generator=g) * 6.283 - 3.1416).to(dev)
    B = rc.ray_feature_matrix(pos, yaw, torch.zeros(n, device=dev))
    Bt = torch.nn.functional.pad(B.transpose(1, 2), (0, 0, 0, 6)).contiguous()
    _, d_t, _, _, rt = rc.pinhole_constants(90.0, BENCH["height"], BENCH["width"], dev)
    sids = torch.zeros(n, dtype=torch.int32, device=dev)
    n_tests = n * BENCH["height"] * BENCH["width"] * T
    synth = compare_kernel(
        "raycast_fused_t", rk.raycast_fused_t, (gm, sids, d_t, Bt), dict(ray_tile=rt, tri_chunk=128),
        n_tests, reps=10, plain_reps=1,
    )
    every["synthetic_8192_tris_n8"] = {k: synth[k] for k in (
        "max_abs_err", "hit_agree", "idx_agree", "ms", "plain_ms", "bound_ms", "bound_by")}
    kernels = [sel, every]
    for tag, r in (("bench reset", sel), ("mid-size reset", every), ("synthetic 8192 tris", synth)):
        log(f"[kernel] {r['name']} on the {tag}: hit {r['hit_agree']:.6f} idx {r['idx_agree']:.6f} "
            f"|dt| {r['max_abs_err']:.3g} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})")

    # ---- 3. main path ----------------------------------------------------
    T_steps = BENCH["num_steps"]
    learner = PPOLearner(env, policy, PPOConfig(num_steps=T_steps))
    rk.raycast_fused_sel_t.launches = rk.raycast_fused_t.launches = 0
    rs = learner.init(seed=0)
    rs, batch, last_value, _, _ = learner.collect_rollout(rs)  # warm-up
    walls = []
    for _ in range(ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs, batch, last_value, _, stats = learner.collect_rollout(rs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    main_launches = {"raycast_fused_sel_t": rk.raycast_fused_sel_t.launches,
                     "raycast_fused_t": rk.raycast_fused_t.launches}
    want = 1 + (1 + ROLLOUTS) * T_steps  # reset render + one per step
    if main_launches != {"raycast_fused_sel_t": want, "raycast_fused_t": 0}:
        fail(f"main path launches {main_launches}, want {want} frustum-selected renders")
    for name, x in (("values", batch.values), ("rewards", batch.rewards), ("log_probs", batch.log_probs),
                    ("last_value", last_value)):
        if not torch.isfinite(x).all():
            fail(f"non-finite {name}")
    with torch.no_grad():
        logits, _, _ = policy(rs.obs, rs.hidden, rs.prev_action, rs.not_done)
    if not torch.isfinite(logits).all() or logits.shape != (BENCH["num_envs"], 4):
        fail("bad logits")
    depth = batch.obs["depth"]
    if depth.shape != (T_steps, BENCH["num_envs"], 128, 128, 1) or not torch.isfinite(depth.float()).all():
        fail("bad depth frames")
    steps = BENCH["num_envs"] * T_steps
    sps = sorted(steps / w for w in walls)
    median_wall = sorted(walls)[ROLLOUTS // 2]

    # per-layer times on the rollout's last state
    state = rs.env_state
    ctx = env._make_ctx(state)
    cam = state.pos + torch.tensor([0.0, 1.25, 0.0], device=dev)
    render_ms = cuda_ms(lambda: rc.render_batch(env.pack, ctx.sid, cam, state.yaw, state.pitch,
                                                 height=128, width=128), 10)
    with torch.no_grad():
        policy_ms = cuda_ms(lambda: policy(rs.obs, rs.hidden, rs.prev_action, rs.not_done), 10)
    actions = torch.ones(BENCH["num_envs"], dtype=torch.int32, device=dev)
    step_ms = cuda_ms(lambda: env.step_fn(state, actions), 10)
    log(f"[main] {gpu}: env-steps/s median {sps[ROLLOUTS // 2]:.1f} over {ROLLOUTS} rollouts "
        f"(min {sps[0]:.1f}, max {sps[-1]:.1f}; walls ms {[round(w * 1e3, 1) for w in walls]} "
        f"for {BENCH['num_envs']}x{T_steps}), render {render_ms:.3f} ms/step, policy {policy_ms:.3f} ms/step, "
        f"env step incl. render {step_ms:.3f} ms/step, episodes done {int(stats['done_count'].item())}, "
        f"launches {main_launches}")

    # one rollout under torch.profiler: device kernel time against the
    # unprofiled median wall (kernels run on one stream) and launch count
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rs, *_ = learner.collect_rollout(rs)
        torch.cuda.synchronize()
    dev_kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA and device_us(e) > 0]
    dev_kernels.sort(key=device_us, reverse=True)
    device_ms = sum(device_us(e) for e in dev_kernels) / 1e3
    log(f"[profile] one rollout: device kernel time {device_ms:.1f} ms, idle share "
        f"{1 - device_ms / (median_wall * 1e3):.3f} of the median unprofiled wall, "
        f"{sum(e.count for e in dev_kernels)} kernel launches")
    for e in dev_kernels[:15]:
        log(f"[profile]   {device_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")

    # mid-size-scene route: every-chunk kernel
    mid_learner = PPOLearner(mid_env, policy, PPOConfig(num_steps=MID["num_steps"]))
    rk.raycast_fused_sel_t.launches = rk.raycast_fused_t.launches = 0
    mrs = mid_learner.init(seed=1)
    mrs, mbatch, mlast, _, _ = mid_learner.collect_rollout(mrs)
    torch.cuda.synchronize()
    mid_launches = {"raycast_fused_sel_t": rk.raycast_fused_sel_t.launches,
                    "raycast_fused_t": rk.raycast_fused_t.launches}
    if mid_launches != {"raycast_fused_sel_t": 0, "raycast_fused_t": 1 + MID["num_steps"]}:
        fail(f"mid-size route launches {mid_launches}")
    if not (torch.isfinite(mbatch.values).all() and torch.isfinite(mlast).all()):
        fail("non-finite values on the mid-size route")
    log(f"[mid] launches {mid_launches}")
    sel["launches"] = main_launches["raycast_fused_sel_t"]
    every["launches"] = mid_launches["raycast_fused_t"]

    # ---- 4. card vs CPU on a small input --------------------------------
    small = dict(num_envs=8, precomputed_fields=fields, max_episode_steps=500, sensor_specs=sensors)
    env_c = make_nav_env(scenes, episodes, device="cpu", **small)
    env_g = make_nav_env(scenes, episodes, **small)
    sc, oc = env_c.reset_fn()
    sg, og = env_g.reset_fn()
    acts = torch.tensor([[1, 1, 2, 3, 1, 1, 2, 1], [1, 2, 1, 1, 3, 1, 1, 0], [1, 1, 1, 2, 1, 3, 1, 1]], dtype=torch.int32)
    worst_depth = 0.0
    for a in acts:
        sc, oc, rc_, dc, _ = env_c.step_fn(sc, a)
        sg, og, rg, dg, _ = env_g.step_fn(sg, a.to(dev))
        if not torch.equal(dc, dg.cpu()) or (rc_ - rg.cpu()).abs().max() > 1e-5:
            fail("env step on the card disagrees with the CPU")
        dd = (oc["depth"] - og["depth"].cpu()).abs()
        if (dd > 1e-4).float().mean() > 1e-3:
            fail(f"depth on the card disagrees with the CPU: {dd.max().item()}")
        worst_depth = max(worst_depth, dd.max().item())
    policy_c = make_pointnav_resnet_policy(4, device="cpu")
    policy_c.load_state_dict({k: v.cpu() for k, v in policy.state_dict().items()})
    hid = torch.zeros(8, 1, 2, 512)
    prev = torch.zeros(8, dtype=torch.int32)
    with torch.no_grad():
        lc, vc, _ = policy_c(oc, hid, prev, torch.zeros(8))
        lg, vg, _ = policy({k: v.to(dev) for k, v in oc.items()}, hid.to(dev), prev.to(dev), torch.zeros(8, device=dev))
    policy_err = max((lc - lg.cpu()).abs().max().item(), (vc - vg.cpu()).abs().max().item())
    if policy_err > 3e-2:
        fail(f"policy on the card disagrees with the CPU: {policy_err}")
    log(f"[check] card vs CPU: dones/rewards equal over 3 steps, max depth diff {worst_depth:.3g}, "
        f"policy logits/values max diff {policy_err:.3g}")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
