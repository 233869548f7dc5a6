"""Where a 2-rank DD-PPO step and the one-process step part on the CPU:
``chip_smoke.py``'s [ddppo-2rank] config (N=8 as 2 x 4, 64x64 depth,
resnet18 + LSTM-128, float32, T=8, 2 epochs of 2 minibatches) run over gloo
in two processes and in one.

    python scripts/ddppo_cpu_divergence.py

Prints the parameters' elements beyond rtol 2e-4 / atol 2e-5 of the
one-process step; before each Adam step the largest weight gap and the
step's largest gradient gap (after the clip); step 2 replayed in one
process from the one-process and the 2-rank weights (its gradient gap
before the clip) with the stem max pool's credit maps (how many windows
credit each input) there; and, as a control, the one-process step at 1
thread against 2.
"""

import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from habitat_torch.baselines.ppo import PPOConfig, PPOLearner  # noqa: E402
from habitat_torch.models import resnet  # noqa: E402
from habitat_torch.ops import pool  # noqa: E402
from habitat_torch.parallel import distributed  # noqa: E402

C = cs.DDPPO_2RANK
DEV = torch.device("cpu")


def learner():
    rows = distributed.env_rows(C["num_envs"])
    return PPOLearner(cs.small_nav_env(DEV, C["num_envs"], C["hw"], rows.slice), cs.two_rank_policy(DEV, True),
                      PPOConfig(**C["ppo"]), rows=rows)


def state(lrn):
    return {k: v.detach().clone() for k, v in lrn.policy.state_dict().items()}


def train_step(threads):
    """``init`` and one train step: (final parameters, per Adam step (the
    weights before it, its gradients after the clip), per step the loss's
    minibatch arguments)."""
    torch.set_num_threads(threads)
    lrn = learner()
    names = {p: k for k, p in lrn.policy.named_parameters()}
    steps, mbs = [], []
    step, loss_fn = lrn.optimizer.step, lrn._loss_fn

    def recorded_step(*a, **k):
        steps.append((state(lrn), {n: p.grad.detach().clone() for p, n in names.items() if p.grad is not None}))
        return step(*a, **k)

    def recorded_loss(mb, h0, **kw):
        mbs.append((mb, h0, kw))
        return loss_fn(mb, h0, **kw)

    lrn.optimizer.step, lrn._loss_fn = recorded_step, recorded_loss
    lrn.train_step(lrn.init(seed=0))
    return state(lrn), steps, mbs


def beyond(got, want):
    n = sum(int(((got[k] - v).abs() > cs.DDPPO_ATOL + cs.DDPPO_RTOL * v.abs()).sum()) for k, v in want.items())
    return n, sum(v.numel() for v in want.values())


def largest_gap(a, b):
    gaps = {k: float((a[k] - b[k]).abs().max()) for k in a}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def replay(weights, mb, h0, kw):
    """One loss and backward from ``weights`` in this process: (gradients
    before the clip, the stem pool's credit map, its input)."""
    lrn = learner()
    lrn.policy.load_state_dict(weights)
    seen = {}

    def spy(x):
        seen["x"], seen["y"] = x.detach(), resnet_pool(x).detach()
        return resnet_pool(x)

    resnet.max_pool_3x3s2 = spy
    try:
        loss, _ = lrn._loss_fn(mb, h0, **kw)
        loss.backward()
    finally:
        resnet.max_pool_3x3s2 = resnet_pool
    credit = pool.max_pool_3x3s2_bwd_plain(seen["x"], seen["y"], torch.ones_like(seen["y"]))
    return {k: p.grad.detach().clone() for k, p in lrn.policy.named_parameters() if p.grad is not None}, credit, seen["x"]


resnet_pool = resnet.max_pool_3x3s2


def main():
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "2"}
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), tmp], env=env)
                 for r in range(2)]
        if any(p.wait(timeout=900) for p in procs):
            raise SystemExit("a rank failed")
        two, two_steps = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=True)
    one, one_steps, mbs = train_step(2)
    n, total = beyond(two, one)
    print(f"2 ranks vs 1 process: {n} of {total} elements beyond rtol {cs.DDPPO_RTOL} / atol {cs.DDPPO_ATOL}, "
          f"max gap {largest_gap(two, one)[0]:.3g}")
    for s, ((w1, g1), (w2, g2)) in enumerate(zip(one_steps, two_steps)):
        dw, kw_ = largest_gap(w1, w2)
        dg, kg = largest_gap(g1, g2)
        print(f"Adam step {s + 1}: weight gap before it {dw:.3g} ({kw_}); its gradient gap after the clip "
              f"{dg:.3g} ({kg})")
    mb, h0, kw = mbs[1]
    (g1, c1, x1), (g2, c2, x2) = replay(one_steps[1][0], mb, h0, kw), replay(two_steps[1][0], mb, h0, kw)
    dg, kg = largest_gap(g1, g2)
    print(f"step 2 replayed in one process from both weight sets: gradient gap before the clip {dg:.3g} ({kg}); "
          f"stem pool input gap {float((x1 - x2).abs().max()):.3g}; inputs whose pool credit differs "
          f"{int((c1 != c2).sum())} of {c1.numel()}")
    other, _, _ = train_step(1)
    n, total = beyond(other, one)
    print(f"control, one process at 1 thread vs 2: {n} of {total} elements beyond, max gap "
          f"{largest_gap(other, one)[0]:.3g}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank, folder = int(sys.argv[2]), sys.argv[3]
        distributed.init_distributed(f"file://{folder}/store", 2, rank, device="cpu", timeout_s=300)
        params, steps, _ = train_step(2)
        if rank == 0:
            torch.save((params, steps), os.path.join(folder, "rank0.pt"))
        distributed.abort()
    else:
        main()
