"""The ResNet stem's 3x3, stride-2, "SAME" max pool with a CUDA backward
(port of ``habitat_tpu/ops/pool.py``).

``max_pool_3x3s2(x)`` takes (N, C, H, W) tensors with even H and W, the
only SAME case the policy has: XLA pads one row and one column of -inf at
the high end. The policy's activations are channels-last in memory (the
encoder permutes NHWC observations into an NCHW view and the layers keep
that layout); the kernel reads that layout only, the plain version any.

- The forward is XLA's ``reduce_window`` (``F.max_pool2d`` on the padded
  input), bit-equal to ``flax.linen.max_pool``.
- The backward credits every tied input: ``gx[p] = sum_w dy[w] * (x[p] ==
  y[w])`` over the <= 4 windows covering p. ``flax.linen.max_pool``'s VJP
  (XLA's select-and-scatter) and ``F.max_pool2d``'s credit one tied input
  only, so gradients upstream of the pool differ where a window holds two
  equal maxima (positive bf16 ties after the stem's ReLU).

``max_pool_3x3s2_bwd`` launches the kernel of ``csrc/maxpool_bwd.cu`` on card
tensors (built at first use, ``ops/cuda_build.py``) and raises on what it
does not take: a thread there moves 16 bytes of channels at a time, so C
must be a multiple of ``VEC[dtype]`` and each tensor 16-byte aligned. CPU
tensors take the plain version ``max_pool_3x3s2_bwd_plain`` (any C), which
sums in the kernel's order, so the two agree bit for bit. The wrapper counts
its launches in ``launches`` and names its plain version in ``plain``;
``maxpool_bwd_design`` reports the kernel's build.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from habitat_torch.ops import cuda_build

# channels per 16 bytes: the kernel's vector width for each dtype it takes
VEC = {torch.float32: 4, torch.bfloat16: 8}


def _check_even(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2 or x.shape[2] < 2 or x.shape[3] < 2:
        raise ValueError(f"the 3x3/2 SAME max pool takes (N, C, H, W) with even H and W, got {tuple(x.shape)}")


def max_pool_3x3s2_bwd_plain(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Gather form of the all-ties backward (the counterpart of the JAX
    package's ``_bwd_xla``): for each input, the covering windows in order
    (window row ascending, then window column), summed in float32 and
    rounded once to x's dtype."""
    H, W = x.shape[2], x.shape[3]
    dev = x.device
    # one -inf / 0 window before the first, so window index a sits at a + 1
    yp = F.pad(y, (1, 0, 1, 0), value=float("-inf"))
    dp = F.pad(dy.float(), (1, 0, 1, 0))
    hh, ww = torch.arange(H, device=dev), torch.arange(W, device=dev)
    # input row h lies in window rows h//2 - 1 (even h only) and h//2
    rows = ((hh // 2, hh % 2 == 0), (hh // 2 + 1, None))
    cols = ((ww // 2, ww % 2 == 0), (ww // 2 + 1, None))
    acc = torch.zeros_like(x, dtype=torch.float32)
    for r, r_ok in rows:
        for c, c_ok in cols:
            ys = yp[:, :, r][:, :, :, c]
            hit = x == ys
            if r_ok is not None:
                hit = hit & r_ok[:, None]
            if c_ok is not None:
                hit = hit & c_ok
            acc = acc + torch.where(hit, dp[:, :, r][:, :, :, c], 0.0)
    return acc.to(x.dtype)


def _layout(x: torch.Tensor) -> torch.memory_format:
    """Channels-last for the kernel; on the CPU also NCHW-contiguous."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    if x.is_contiguous() and x.device.type == "cpu":
        return torch.contiguous_format
    raise ValueError(
        f"x: expected a channels-last tensor (or an NCHW-contiguous one on the CPU), "
        f"got strides {x.stride()} on {x.device}"
    )


def max_pool_3x3s2_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """gx (N, C, H, W) from x (N, C, H, W), y and dy (N, C, H/2, W/2), all of
    one dtype (float32 or bfloat16) on one device and in one memory layout
    (channels-last; on the CPU NCHW-contiguous too); gx has that layout."""
    _check_even(x)
    N, C, H, W = x.shape
    fmt = _layout(x)
    for name, t, shape in (("y", y, (N, C, H // 2, W // 2)), ("dy", dy, (N, C, H // 2, W // 2))):
        if t.dtype != x.dtype or t.device != x.device or not t.is_contiguous(memory_format=fmt):
            raise ValueError(
                f"{name}: expected a {x.dtype} tensor on {x.device} in x's layout {fmt}, "
                f"got {t.dtype} on {t.device} with strides {t.stride()}"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if x.dtype not in VEC:
        raise ValueError(f"x: expected float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return max_pool_3x3s2_bwd_plain(x, y, dy)
    if C % VEC[x.dtype] or any(t.data_ptr() % 16 for t in (x, y, dy)):
        raise ValueError(
            f"the kernel takes {x.dtype} channels in groups of {VEC[x.dtype]} from 16-byte aligned tensors, got "
            f"C={C} at addresses {[hex(t.data_ptr()) for t in (x, y, dy)]}"
        )
    if x.numel() // VEC[x.dtype] + 128 > 2**32 - 1:
        raise ValueError(f"x: the kernel indexes 16-byte groups in 32 bits, {x.numel()} elements are too many")
    lib = cuda_build.load("maxpool_bwd")
    gx = torch.empty_like(x, memory_format=fmt)
    err = lib.maxpool_bwd(
        x.data_ptr(), y.data_ptr(), dy.data_ptr(), gx.data_ptr(),
        N, C, H, W, int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.raise_on(err, "maxpool_bwd")
    max_pool_3x3s2_bwd.launches += 1
    return gx


max_pool_3x3s2_bwd.launches = 0
max_pool_3x3s2_bwd.plain = max_pool_3x3s2_bwd_plain

_DESIGN_KEYS = ("channels_per_thread", "window_rows_per_thread", "threads_per_block", "registers", "spill_bytes",
                "static_smem_bytes", "blocks_per_sm")


def maxpool_bwd_design(dtype: torch.dtype = torch.bfloat16) -> dict:
    """The kernel's design for ``dtype`` on the current card, as the library
    reports it (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor): channels and window rows
    per thread, threads per block, registers and spilled bytes per thread,
    static shared bytes, blocks per SM."""
    out = (ctypes.c_int * len(_DESIGN_KEYS))()
    err = cuda_build.load("maxpool_bwd").maxpool_bwd_design(int(dtype == torch.bfloat16), ctypes.addressof(out))
    cuda_build.raise_on(err, "maxpool_bwd_design")
    return dict(zip(_DESIGN_KEYS, out))


class _MaxPool3x3s2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)
        y = y.contiguous(memory_format=_layout(x))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        # autograd picks dy's layout; the kernel reads x's
        return max_pool_3x3s2_bwd(x, y, dy.contiguous(memory_format=_layout(x)))


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 SAME max pool of an (N, C, H, W) tensor with even H and W; its
    gradient credits every tied input."""
    _check_even(x)
    return _MaxPool3x3s2.apply(x)
