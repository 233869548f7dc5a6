"""habitat_torch's worker-backed vector envs (``core/vector_env.py``) and the
thread-safe builds of ``ops/cuda_build.py`` and ``native/`` on the CPU.

- ``ThreadedVectorEnv`` of two ``RLTaskEnv`` on ``pointnav_procgen.yaml`` at
  tests/test_env_api.py's small overrides against the JAX package's
  ``ThreadedVectorEnv`` of the same, through a fixed action script whose
  stops and step limits make the workers auto-reset: observations and
  metrics within 1e-5 (as tests/test_torch_env_api.py holds the single
  env), rewards, dones, ``count_episodes`` and the ``number_of_episodes``
  call exactly.
- ``VectorEnv`` (forkserver, 2 worker processes) against one port env in
  this process, given the same actions: every return equal.
- The one-outstanding-message assertions, pause/resume, ``call_at``,
  ``render`` and ``close`` twice.
- Worker errors, in both variants: a ``make_env_fn`` that raises, a
  ``step`` that raises and a worker that ends without replying
  (``os._exit(7)`` in a process, ``SystemExit`` in a thread) each make the
  parent raise ``RuntimeError`` naming the worker and the command within
  60 s (the call runs in a thread joined with that deadline), and
  ``close()`` then returns.
- Two threads that load the native helper or a kernel library at once,
  from a fresh build directory, get one library, built once.
"""

import ctypes
import os
import re
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from habitat_tpu.config.default import get_config as jax_get_config
from habitat_tpu.core.environments import RLTaskEnv as JaxRLTaskEnv
from habitat_tpu.core.vector_env import ThreadedVectorEnv as JaxThreadedVectorEnv

from habitat_torch import native
from habitat_torch.core.vector_env import ThreadedVectorEnv, VectorEnv
from habitat_torch.ops import cuda_build

from tests.test_torch_env_api import CFG, SMALL
from tests.torch_vector_env_worker import make_rl_env, make_stub
from tests.torch_jax_native import _jax_native  # noqa: F401

ATOL = 1e-5
# two envs' actions: env 0 stops at step 4 and again at 19; env 1 runs into
# the 20-step limit and then stops at step 25
SCRIPT = ([[1, 2], [1, 1], [3, 1], [0, 2]] + [[1, 1], [2, 3], [1, 1]] * 5
          + [[0, 1], [1, 1], [2, 1], [1, 3], [1, 1], [1, 0], [1, 1]])
DEADLINE_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same_obs(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=0, atol=ATOL, err_msg=f"{k}@{what}")


def _same_step(got, want, what):
    (go, gr, gd, gi), (wo, wr, wd, wi) = got, want
    _same_obs(go, wo, what)
    assert (gr, gd) == (wr, wd), what
    assert set(gi) == set(wi), what
    for k in wi:
        np.testing.assert_allclose(float(gi[k]), float(wi[k]), rtol=0, atol=ATOL, err_msg=f"{k}@{what}")


def test_threaded_matches_jax():
    envs = ThreadedVectorEnv(make_rl_env, [(SMALL,), (SMALL,)], device="cpu")
    jenvs = JaxThreadedVectorEnv(lambda c: JaxRLTaskEnv(c), [(jax_get_config(CFG, SMALL),)] * 2)
    try:
        assert envs.number_of_episodes == jenvs.number_of_episodes == [6, 6]
        assert envs.action_names[0] == ("stop", "move_forward", "turn_left", "turn_right")
        assert envs.observation_shapes[0]["depth"][0] == (32, 32, 1)
        for i, (o, jo) in enumerate(zip(envs.reset(), jenvs.reset())):
            _same_obs(o, jo, f"reset {i}")
        dones = 0
        for t, actions in enumerate(SCRIPT):
            for i, (got, want) in enumerate(zip(envs.step(actions), jenvs.step(actions))):
                _same_step(got, want, f"step {t} env {i}")
                assert isinstance(got[1], float) and got[0]["depth"].device.type == "cpu"
                dones += got[2]
        assert dones == 4
        assert envs.count_episodes() == jenvs.count_episodes() == [6, 6]
        assert envs.call(["number_of_episodes"] * 2) == jenvs.call(["number_of_episodes"] * 2) == [6, 6]
    finally:
        envs.close()
        jenvs.close()


def test_processes_match_an_env_in_this_process():
    local = make_rl_env(SMALL)
    envs = VectorEnv(make_rl_env, [(SMALL,), (SMALL,)], multiprocessing_start_method="forkserver", device="cpu")
    try:
        assert envs.number_of_episodes == [6, 6] and envs.action_names == [local.action_names] * 2
        want = local.reset()
        for obs in envs.reset():
            assert set(obs) == set(want) and all(torch.equal(obs[k], want[k]) for k in want)
        for t, actions in enumerate(SCRIPT[:12]):
            got = envs.step_at(0, actions[0])
            o, r, d, info = local.step(actions[0])
            if d:
                o = local.reset()
            assert all(torch.equal(got[0][k], o[k]) for k in o), t
            assert (got[1], got[2], dict(got[3])) == (r, d, dict(info)), t
        assert envs.call_at(1, "number_of_episodes") == 6
        assert envs.render().shape == (32, 64, 3)
    finally:
        envs.close()
    envs.close()


@pytest.mark.parametrize("cls", [ThreadedVectorEnv, VectorEnv])
def test_outstanding_message_and_pause(cls):
    envs = cls(make_stub, [(None,), (None,), (None,)], device="cpu")
    try:
        envs.reset()
        envs.async_step_at(0, 1)
        with pytest.raises(AssertionError):
            envs.async_step_at(0, 1)
        obs, reward, done, _ = envs.wait_step_at(0)
        assert torch.equal(obs["x"], torch.ones(2)) and (reward, done) == (1.0, False)
        with pytest.raises(AssertionError):
            envs.wait_step_at(0)
        envs.pause_at(1)
        assert envs.num_envs == 2 and len(envs.action_names) == 2
        assert [r[0]["x"][0].item() for r in envs.step([1, 1])] == [2.0, 1.0]
        envs.resume_all()
        assert envs.num_envs == 3 and envs.observation_shapes[1] == {"x": ((2,), torch.float32)}
        assert [r[0]["x"][0].item() for r in envs.step([1, 1, 1])] == [3.0, 1.0, 2.0]
        assert envs.count_episodes() == [1, 1, 1]
        assert envs.render().shape == (8, 8, 3)
    finally:
        envs.close()


def _within_deadline(fn):
    """fn() run in a thread joined within DEADLINE_S; returns its exception."""
    box = {}

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - the test inspects it
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    t0 = time.monotonic()
    th.start()
    th.join(DEADLINE_S)
    assert not th.is_alive(), f"no answer within {DEADLINE_S} s"
    return box.get("error"), time.monotonic() - t0


# the stub's SystemExit ends its worker thread, which pytest reports
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("cls", [ThreadedVectorEnv, VectorEnv])
def test_worker_errors_are_forwarded(cls):
    err, _ = _within_deadline(lambda: cls(make_stub, [(None,), ("make",)], device="cpu"))
    assert isinstance(err, RuntimeError) and "worker 1" in str(err) and "make_env_fn" in str(err)
    assert "could not be built" in str(err)

    envs = cls(make_stub, [(None,), (None,)], device="cpu")
    envs.reset()
    err, _ = _within_deadline(lambda: envs.step(["boom", 1]))
    assert isinstance(err, RuntimeError) and "worker 0" in str(err) and "'step'" in str(err)
    assert "asked to fail" in str(err)
    err, _ = _within_deadline(lambda: envs.call_at(1, "exit", {"code": 7}))
    assert isinstance(err, RuntimeError) and "worker 1" in str(err) and "'call'" in str(err)
    if cls is VectorEnv:
        assert "exit code 7" in str(err)
    err, _ = _within_deadline(envs.close)
    assert err is None
    assert not any(w.alive() for w in envs._workers)


def _so_copy(dst):
    """A real shared library at ``dst`` (a copy of the native helper)."""
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copy(native._SO, dst)


def _race(load):
    """load() from two threads released at once; returns both results."""
    barrier, out = threading.Barrier(2), [None, None]

    def run(i):
        barrier.wait()
        out[i] = load()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(DEADLINE_S)
    assert not any(th.is_alive() for th in threads)
    return out


def test_two_threads_build_one_library(tmp_path, monkeypatch):
    native.get_lib()  # the helper the kernel case copies
    calls = []
    compile_ = native._compile

    def counted(out):
        calls.append(out)
        time.sleep(0.2)  # hold the build long enough for the other thread to arrive
        compile_(out)

    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "native"))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "native" / "libhabitat_native.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_compile", counted)
    a, b = _race(native.get_lib)
    assert a is b and isinstance(a, ctypes.CDLL) and len(calls) == 1
    assert re.search(rf"\.{os.getpid()}\.\d+\.tmp$", calls[0])  # named by pid and thread id
    assert os.listdir(tmp_path / "native") == ["libhabitat_native.so"]

    src = tmp_path / "csrc" / "fake.cu"
    src.parent.mkdir()
    src.write_text("// stand-in source\n")
    built = []

    def fake_build(names):
        built.append(tuple(names))
        time.sleep(0.2)
        for name in names:
            _so_copy(cuda_build._so(name))
        return {}

    monkeypatch.setattr(cuda_build, "_BUILD", str(tmp_path / "kernels"))
    monkeypatch.setattr(cuda_build, "_src", lambda name: str(src))
    monkeypatch.setattr(cuda_build, "SOURCES", {"fake": {"geodesic_field": []}})
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_build", fake_build)
    a, b = _race(lambda: cuda_build.load("fake"))
    assert a is b and built == [("fake",)]
    cuda_build.ensure_built(("fake",))  # up to date: nothing to build
    assert built == [("fake",)]
