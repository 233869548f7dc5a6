"""habitat_torch's Threefry draws (``utils/threefry.py``) and the draws of its
sampling agents against ``jax.random`` on the CPU.

- ``split``, ``randint`` (int32) and the uniforms under ``gumbel`` are
  bit-equal to JAX's over several seeds and shapes, ``randint`` also at an
  empty span and at the int32 edges.
- ``gumbel``: each logarithm is taken in float64 and rounded to float32;
  XLA's float32 ``log`` is within one unit in the last place of that, so
  the noise is held to JAX's within 1e-6 absolute (the largest gap measured
  is 4.77e-7, at values near 0 where -log(u) is near 1).
- ``categorical`` on 20,000 rows of random logits per seed picks JAX's
  action on every row.
- ``NnSkill`` (not deterministic) samples JAX's ``categorical(PRNGKey(0),
  logits)`` on the same logits, at two batch sizes, and keeps one noise
  table per size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_torch.utils import threefry as tf

SEEDS = (0, 1, 7, 123456, 2 ** 31 - 1)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jdraws():
    """The JAX draws, each jitted once (static shapes)."""
    return dict(
        gumbel=jax.jit(jax.random.gumbel, static_argnums=1),
        categorical=jax.jit(jax.random.categorical),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed):
    key, k = jax.random.PRNGKey(seed), tf.prng_key(seed)
    for num in (2, 3, 5):
        np.testing.assert_array_equal(tf.split(k, num), np.asarray(jax.random.split(key, num)))
    # a batch of keys splits key by key
    keys = tf.split(k, 4)
    np.testing.assert_array_equal(tf.split(keys, 3)[2], tf.split(keys[2], 3))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [((32,), 0, 97), ((4, 5), -3, 11), ((7,), 0, 1), ((6,), 5, 5),
                                         ((3,), 0, 2 ** 31 - 1), ((5,), -2 ** 31, 2 ** 31 - 1), ((9,), 0, 105)])
def test_randint_matches_jax(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
    got = tf.randint(tf.prng_key(seed), shape, lo, hi)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_matches_jax(jdraws, seed):
    key, k = jax.random.PRNGKey(seed), tf.prng_key(seed)
    # the uniforms under the noise are JAX's bit for bit
    u = np.asarray(jax.random.uniform(key, (1000, 6), jnp.float32, np.finfo(np.float32).tiny, 1.0))
    np.testing.assert_array_equal(tf.uniform(k, 6000, tf.TINY, 1.0).reshape(1000, 6), u)
    want = np.asarray(jdraws["gumbel"](key, (1000, 6)))
    got = tf.gumbel(k, (1000, 6))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(jdraws, seed):
    logits = np.random.default_rng(seed).normal(size=(20000, 4)).astype(np.float32)
    want = np.asarray(jdraws["categorical"](jax.random.PRNGKey(seed), jnp.asarray(logits)))
    got = tf.categorical(tf.prng_key(seed), logits)
    assert (got != want).sum() == 0
    assert set(np.unique(got)) == {0, 1, 2, 3}


class _Net:
    hidden_size, num_recurrent_layers, rnn_type = 4, 1, "LSTM"


def test_nn_skill_samples_jax_draws():
    """A stub policy gives fixed logits; JAX's and the port's skills act on
    them through their own ``act``."""
    from habitat_tpu.baselines.hrl import hierarchical as jh
    from habitat_torch.baselines.hrl import hierarchical as th

    class JaxPolicy:
        net = _Net()

        def __init__(self, logits):
            self.logits = logits

        def apply(self, params, obs, *a):
            return jnp.asarray(self.logits), None, None

    class TorchPolicy:
        def __init__(self, logits):
            self.logits = logits

        def initial_hidden(self, n):
            return torch.zeros(n, 1, 2, 4)

        def __call__(self, obs, *a):
            return torch.from_numpy(self.logits), None, None

    tskill = th.NnSkill(TorchPolicy(None), done_fn=None, obs_fn=lambda env, s: {}, deterministic=False)
    for n in (6, 64, 6):
        logits = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32) * 0.5
        jskill = jh.NnSkill(JaxPolicy(logits), None, done_fn=None, obs_fn=lambda env, s: {}, deterministic=False)
        env = type("Env", (), dict(num_envs=n, device=torch.device("cpu")))()
        want = np.asarray(jskill.act(env, None))
        tskill.policy.logits = logits
        got = tskill.act(env, None)
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(set(want.tolist())) > 1
    assert sorted(tskill._noise) == [(6, 5, "cpu"), (64, 5, "cpu")]
