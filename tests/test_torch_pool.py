"""habitat_torch's stem max pool (``ops/pool.py``) against habitat_tpu's
``max_pool_3x3s2`` on the same numpy inputs, run as ``tests/test_pool.py``
runs it: ``max_pool_3x3s2(x, True)`` takes the Pallas kernel in interpret
mode on ``_supported`` shapes and the gather form otherwise.

On the CPU the port's backward is its plain version. The JAX side is NHWC,
the port's NCHW; a permuted NHWC array is a channels-last NCHW tensor, the
layout the policy's stem hands to the pool, and the NCHW-contiguous copy
must give the same bits.

Tolerances are those of ``tests/test_pool.py``: 1e-6 in float32 (the sum of
up to four window gradients in another order), 2e-2 in bfloat16 (the JAX
side sums in bfloat16, the port in float32 with one rounding at the end).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.ops.pool import _supported, _xla_maxpool
from habitat_tpu.ops.pool import max_pool_3x3s2 as jax_max_pool

from habitat_torch.ops import pool

from tests.test_pool import _oracle_bwd

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores:
    PyTorch's CPU kernels, one thread per core in each of them, then spend
    their time waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    n, h, w, c = shape
    dy = rng.standard_normal((n, h // 2, w // 2, c)).astype(np.float32)
    return x, dy


def _port(a, dtype, channels_last=True):
    """NHWC numpy -> NCHW torch (channels-last in memory, or contiguous)."""
    t = torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)
    return t if channels_last else t.contiguous()


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _port_grad(x, dy, dtype, channels_last=True):
    xt = _port(x, dtype, channels_last).requires_grad_(True)
    y = pool.max_pool_3x3s2(xt)
    (gx,) = torch.autograd.grad(y, xt, _port(dy, dtype, channels_last))
    return y.detach(), gx


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(128, 32, 32, 8), (3, 32, 32, 8)])
def test_forward_bit_equal(shape, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    x, _ = _inputs(shape, 0)
    ref = np.asarray(_xla_maxpool(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    y = pool.max_pool_3x3s2(_port(x, tdt))
    assert y.dtype == tdt
    np.testing.assert_array_equal(_nhwc(y), ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(128, 32, 32, 8), (3, 32, 32, 8)])
def test_backward_matches_jax(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, dy = _inputs(shape, 1)
    xj, dyj = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    assert _supported(xj) == (shape[0] == 128)  # the Pallas kernel, or the gather form
    _, vjp = jax.vjp(lambda v: jax_max_pool(v, True), xj)
    ref = np.asarray(vjp(dyj)[0].astype(jnp.float32))
    y, gx = _port_grad(x, dy, tdt)
    assert gx.dtype == tdt and gx.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(gx), ref, atol=tol, rtol=tol)
    # the NCHW-contiguous layout gives the same bits
    _, gx_c = _port_grad(x, dy, tdt, channels_last=False)
    assert gx_c.is_contiguous()
    assert torch.equal(gx_c, gx)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 2, 2, 8), (3, 32, 64, 8)])
def test_backward_matches_jax_at_edge_shapes(shape, dtype):
    """The kernel's edge shapes (one window, H != W, C = 8) on the plain
    backward, against the JAX package's gather form (``_supported`` refuses
    them)."""
    jdt, tdt, tol = DTYPES[dtype]
    x, dy = _inputs(shape, 4)
    xj, dyj = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    assert not _supported(xj)
    _, vjp = jax.vjp(lambda v: jax_max_pool(v, True), xj)
    ref = np.asarray(vjp(dyj)[0].astype(jnp.float32))
    _, gx = _port_grad(x, dy, tdt)
    assert gx.dtype == tdt and gx.shape == (shape[0], shape[3], shape[1], shape[2])
    np.testing.assert_allclose(_nhwc(gx), ref, atol=tol, rtol=tol)


def test_backward_credits_every_tie():
    """bf16 input built to hold many positive ties (values on a coarse grid),
    against test_pool.py's numpy all-ties oracle; XLA's and torch's own
    gradients credit one tied input and differ here."""
    rng = np.random.default_rng(2)
    x = (rng.integers(0, 6, (4, 16, 16, 8)) * 0.25).astype(np.float32)
    dy = rng.standard_normal((4, 8, 8, 8)).astype(np.float32)
    xb, dyb = (np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)) for a in (x, dy))
    y, gx = _port_grad(x, dy, torch.bfloat16)
    oracle = _oracle_bwd(xb, _nhwc(y), dyb)
    np.testing.assert_allclose(_nhwc(gx), oracle, atol=2e-2, rtol=2e-2)
    credited = (_nhwc(gx) != 0).sum()
    xt = _port(x, torch.float32).requires_grad_(True)
    padded = torch.nn.functional.pad(xt, (0, 1, 0, 1), value=float("-inf"))
    (g_one,) = torch.autograd.grad(torch.nn.functional.max_pool2d(padded, 3, 2), xt, _port(dyb, torch.float32))
    assert credited > (g_one != 0).sum().item() * 1.2  # ties are common on this input


def test_plain_sums_in_window_order():
    """The plain version is the kernel's oracle on the card: float32 sums in
    window order, one rounding. On a tie-free float32 input it equals
    F.max_pool2d's own gradient exactly where one window credits, and both
    layouts give equal bits."""
    x, dy = _inputs((2, 16, 16, 4), 3)
    _, gx = _port_grad(x, dy, torch.float32)
    xt = _port(x, torch.float32).requires_grad_(True)
    padded = torch.nn.functional.pad(xt, (0, 1, 0, 1), value=float("-inf"))
    (ref,) = torch.autograd.grad(torch.nn.functional.max_pool2d(padded, 3, 2), xt, _port(dy, torch.float32))
    torch.testing.assert_close(gx, ref, rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 3, 6, 6)
    y = torch.zeros(2, 3, 3, 3)
    with pytest.raises(ValueError, match="even H and W"):
        pool.max_pool_3x3s2(torch.zeros(2, 3, 5, 6))
    with pytest.raises(ValueError, match="dy"):
        pool.max_pool_3x3s2_bwd(x, y, y.double())
    with pytest.raises(ValueError, match="shape"):
        pool.max_pool_3x3s2_bwd(x, y, torch.zeros(2, 3, 3, 4))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pool.max_pool_3x3s2_bwd(x.half(), y.half(), y.half())
    with pytest.raises(ValueError, match="layout"):
        pool.max_pool_3x3s2_bwd(x, y, y.permute(0, 1, 3, 2))
