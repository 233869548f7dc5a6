#!/usr/bin/env python3
"""Why chip_smoke.py's float32 [check] gate depends on its start.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 check_diagnosis.py

[check] holds one PPO update (N=8, T=4, 2 epochs, one minibatch) on the card
against the same update on the CPU, per trained tensor, within lr/10. This
script runs that float32 update from three starts: the initial weights of
CHECK_SEEDS[0], [check]'s first fixed start (check_start) and the weights
after 3 bench train steps on the card (N=64, T=32). For each it logs the
elements outside lr/10 and the tensors under the gate; how many of those
start from first-step gradients of opposite sign on card and CPU, and their
size against Adam's eps; the first-step gradients' relative L2 gap per
tensor; how far two card updates from one start disagree, with cuDNN's
default and with its deterministic algorithms; the same with PyTorch's own
convolutions instead of cuDNN's, and with a single-credit stem max pool on
both devices; each GroupNorm's float32 variance error against a float64
two-pass variance; and the stem max-pool windows with tied maxima.
"""

import contextlib
import sys
from unittest import mock

import chip_smoke as cs

TRAINED_STEPS = 3  # bench train steps (N=64) before the trained start


def probed_update(dtype, device, start, data, upd, cudnn="default", probe=None, single_credit=False):
    """chip_smoke.one_update with more to read: returns (losses, each trained
    tensor's change, its first Adam step's clipped gradient). ``cudnn``:
    "default", "deterministic" or "off" (PyTorch's own convolutions);
    ``single_credit``: the stem's max pool credits one tied maximum
    (F.max_pool2d's rule). With a dict ``probe``, the first forward records
    each GroupNorm's float32 variance error and the stem max pool's tie
    sets."""
    import torch
    import torch.nn.functional as F

    from habitat_torch.baselines.ppo import PPOLearner
    from habitat_torch.models import resnet
    from habitat_torch.models.policy import make_pointnav_resnet_policy

    d = data["cpu" if torch.device(device).type == "cpu" else "card"]
    net = make_pointnav_resnet_policy(4, dtype=dtype, device=device)
    net.load_state_dict(start)
    lrn = PPOLearner(d["env"], net, upd)
    grads, adam_step = {}, lrn.optimizer.step

    def step(*a, **k):
        if not grads:
            grads.update({n: p.grad.detach().cpu().clone() for n, p in net.named_parameters() if p.requires_grad})
        return adam_step(*a, **k)

    lrn.optimizer.step = step
    hooks = []
    stem_pool = resnet.max_pool_3x3s2
    with contextlib.ExitStack() as stack:
        stack.enter_context(cs.cudnn_deterministic(cudnn == "deterministic"))
        if cudnn == "off":  # PyTorch's own convolutions hand the pool NCHW tensors
            before = torch.backends.cudnn.enabled
            torch.backends.cudnn.enabled = False
            stack.callback(setattr, torch.backends.cudnn, "enabled", before)
            stack.enter_context(mock.patch.object(
                resnet, "max_pool_3x3s2", lambda x: stem_pool(x.contiguous(memory_format=torch.channels_last))))
        if single_credit:
            stack.enter_context(mock.patch.object(
                resnet, "max_pool_3x3s2", lambda x: F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)))
        if probe is not None:
            def gn_hook(name):
                def hook(mod, inp, out):
                    if name in probe:
                        return
                    N, C, H, W = inp[0].shape
                    x = inp[0].float().reshape(N, mod.num_groups, -1)
                    mean = x.mean(-1)
                    var32 = ((x * x).mean(-1) - mean * mean).clamp(min=0.0)
                    x64 = x.double()
                    var64 = (x64 - x64.mean(-1, keepdim=True)).square().mean(-1)
                    rel = ((var32.double() - var64).abs() / (var64 + mod.eps)).max().item()
                    probe[name] = dict(var_rel_err=rel,
                                       mean2_over_var=(mean.double().square() / (var64 + 1e-30)).max().item())
                return hook

            for name, mod in net.named_modules():
                if isinstance(mod, resnet.GroupNorm):
                    hooks.append(mod.register_forward_hook(gn_hook(name)))

            def pool_probe(x):
                if "pool_ties" not in probe:
                    xp = F.pad(x.float(), (0, 1, 0, 1), value=float("-inf"))
                    win = F.unfold(xp, 3, stride=2).reshape(x.shape[0], x.shape[1], 9, -1)
                    probe["pool_ties"] = (win == win.amax(2, keepdim=True)).cpu()
                return stem_pool(x)

            stack.enter_context(mock.patch.object(resnet, "max_pool_3x3s2", pool_probe))
        m = lrn.update(torch.Generator(device=device).manual_seed(0), d["batch"], d["last"], d["h0"])
    for h in hooks:
        h.remove()
    return ({k: v.item() for k, v in m.items() if k.startswith("losses/")},
            {k: p.detach().cpu() - start[k] for k, p in net.named_parameters() if p.requires_grad}, grads)


def diagnose(tag, start, env_c, env_g, upd):
    """The float32 update from ``start`` on its own rollout batch, read as
    the module docstring says."""
    import torch

    dev = torch.device("cuda")
    data = cs.update_data(start, env_c, env_g, upd)
    pg, pc = {}, {}
    f32 = torch.float32
    m1, dg1, gg1 = probed_update(f32, dev, start, data, upd, probe=pg)
    _, dg2, gg2 = probed_update(f32, dev, start, data, upd)
    _, dgd, _ = probed_update(f32, dev, start, data, upd, cudnn="deterministic")
    _, dgd2, _ = probed_update(f32, dev, start, data, upd, cudnn="deterministic")
    mc, dc, gc = probed_update(f32, "cpu", start, data, upd, probe=pc)
    _, dgo, ggo = probed_update(f32, dev, start, data, upd, cudnn="off")
    _, dgs, ggs = probed_update(f32, dev, start, data, upd, single_credit=True)
    _, dcs, gcs = probed_update(f32, "cpu", start, data, upd, single_credit=True)
    off = {k: (dg1[k] - dc[k]).abs() > upd.lr / 10 for k in dc}
    flips = sum(int((off[k] & (torch.sign(gg1[k]) != torch.sign(gc[k]))).sum()) for k in dc)
    g_off = torch.cat([gc[k][off[k]].abs() for k in dc])
    dg_off = torch.cat([(gg1[k] - gc[k])[off[k]].abs() for k in dc])

    def median(x):
        return x.median().item() if x.numel() else 0.0

    def gaps(ga, gb):
        gap = {k: ((ga[k] - gb[k]).norm() / gb[k].norm().clamp(min=1e-30)).item() for k in gb}
        return ", ".join(f"{k.split('backbone.')[-1]} {gap[k]:.3g}" for k in sorted(gap, key=gap.get, reverse=True)[:3])

    def under_gate(da, db):
        return sorted(k.split("backbone.")[-1] for k, r in cs.per_tensor(da, db, upd.lr).items()
                      if r[0] < cs.UPDATE_TENSOR_SHARE or not r[1])

    under = under_gate(dg1, dc)
    gn_worst = sorted((k for k in pg if k != "pool_ties"), key=lambda k: pg[k]["var_rel_err"], reverse=True)[:3]
    # the update's permutation differs between the devices' generators, so
    # the tied windows are counted, not matched
    tied_g, tied_c = (int((p["pool_ties"].sum(2) > 1).sum()) for p in (pg, pc))
    cs.log(
        f"[diagnosis] float32 update from the {tag} start: {sum(int(o.sum()) for o in off.values())} elements "
        f"outside lr/10 in {len(under)} tensors under the gate {under[:6]}; {flips} of them with first-step "
        f"gradients of opposite sign on card and CPU (|g| median {median(g_off):.3g}, |g_card - g_cpu| median "
        f"{median(dg_off):.3g}, Adam eps {upd.eps}); losses card - CPU "
        + ", ".join(f"{k} {m1[k] - mc[k]:.3g}" for k in mc)
        + f"; first-step gradient relative L2 gap, worst: {gaps(gg1, gc)}; with PyTorch's convolutions instead "
        f"of cuDNN's: gap {gaps(ggo, gc)}, under the gate {under_gate(dgo, dc)[:6]}; with a single-credit stem "
        f"max pool on both devices: gap {gaps(ggs, gcs)}, under the gate {under_gate(dgs, dcs)[:6]}; two card "
        f"updates differ in {sum(int((dg1[k] != dg2[k]).sum()) for k in dc)} changes and "
        f"{sum(int((gg1[k] != gg2[k]).sum()) for k in dc)} first-step gradient elements; with cuDNN's "
        f"deterministic algorithms {sum(int((dgd[k] != dgd2[k]).sum()) for k in dc)} changes differ between two "
        f"card runs and {len(under_gate(dgd, dc))} tensors are under the gate; GroupNorm float32 variance "
        f"relative error, worst layers (card / CPU, max mean^2/var): "
        + ", ".join(f"{k} {pg[k]['var_rel_err']:.3g} / {pc[k]['var_rel_err']:.3g} ({pg[k]['mean2_over_var']:.3g})"
                    for k in gn_worst)
        + f"; stem max-pool windows with tied maxima: {tied_g} on the card, {tied_c} on the CPU, of "
        f"{pc['pool_ties'][:, :, 0].numel()}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("check_diagnosis: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.ROOT)
    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav
    from habitat_torch.device import set_numeric_flags
    from habitat_torch.models.policy import make_pointnav_resnet_policy

    set_numeric_flags()
    cs.log(f"[diagnosis] torch {torch.__version__} on {cs.gpu_name_and_power()}: matmul allow_tf32 "
           f"{torch.backends.cuda.matmul.allow_tf32}, cudnn allow_tf32 {torch.backends.cudnn.allow_tf32}")
    sensors = (
        ("HabitatSimDepthSensor", {"height": cs.BENCH["height"], "width": cs.BENCH["width"]}),
        ("HabitatSimRGBSensor", {"height": cs.BENCH["height"], "width": cs.BENCH["width"]}),
        ("PointGoalWithGPSCompassSensor", None),
    )
    scenes, episodes, fields = make_procedural_pointnav(num_scenes=4, episodes_per_scene=16, seed=0)
    small = dict(num_envs=8, precomputed_fields=fields, max_episode_steps=500, sensor_specs=sensors)
    env_c = make_nav_env(scenes, episodes, device="cpu", **small)
    env_g = make_nav_env(scenes, episodes, **small)
    upd = PPOConfig(num_steps=4, ppo_epoch=2, num_mini_batch=1)
    seed = cs.CHECK_SEEDS[0]
    torch.manual_seed(seed)
    diagnose(f"initial (seed {seed})", make_pointnav_resnet_policy(4, device="cpu").state_dict(), env_c, env_g, upd)
    diagnose(f"fixed (check_start, seed {seed})", cs.check_start(env_c, upd, seed), env_c, env_g, upd)
    torch.manual_seed(0)
    policy = make_pointnav_resnet_policy(4)
    env = make_nav_env(scenes, episodes, num_envs=64, precomputed_fields=fields, max_episode_steps=500,
                       sensor_specs=sensors)
    lrn = PPOLearner(env, policy, PPOConfig(**cs.TRAIN))
    state = lrn.init(seed=3)
    for _ in range(TRAINED_STEPS):
        state, _ = lrn.train_step(state)
    trained = {k: v.detach().cpu().clone() for k, v in policy.state_dict().items()}
    diagnose(f"trained ({TRAINED_STEPS} train steps)", trained, env_c, env_g, upd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
