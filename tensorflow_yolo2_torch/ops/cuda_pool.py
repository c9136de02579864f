"""2×2/2 max pool with a hand-written CUDA backward (port of
tensorflow_yolo2_tpu/ops/pallas_pool.py).

``MaxPool2`` is the pool of every Darknet19 stage when a gradient is
recorded: its forward is ``F.max_pool2d(x, 2, 2)`` (on CUDA PyTorch still
writes the int64 indices of its own backward, which nothing here reads),
and its backward is ``max_pool2_bwd_fused``, the kernel of
``csrc/pool.cu`` (B5, replacing ``_pool_bwd_kernel``). The kernel reads x,
y = pool(x) and dout and writes dx once, 2.5·|x| bytes, so bytes bound
it.

The gradient rule is SelectAndScatter's, which is also PyTorch's
``max_pool2d`` backward: in each window, dout goes to the first element
equal to the window's maximum in the order (0,0), (0,1), (1,0), (1,1);
every other element gets 0. ``max_pool2_bwd_plain`` is the same function
as an equality mask in plain PyTorch. The wrapper takes it only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
``MAX_POOL2_BWD_LAUNCHES`` counts kernel launches.

Tensors are NCHW, as the trunk's modules take them; the kernel reads the
NHWC storage of ``channels_last`` memory, which the trunk keeps.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tensorflow_yolo2_torch.utils import cuda_build

MAX_POOL2_BWD_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    global MAX_POOL2_BWD_LAUNCHES
    MAX_POOL2_BWD_LAUNCHES = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("pool")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tfy2_pool2_bwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                   i32, ptr]
    lib.tfy2_pool2_bwd.restype = i32
    return lib


def supported(x: torch.Tensor) -> bool:
    """Shapes where ``MaxPool2`` replaces the SAME 2×2/2 pool exactly:
    4-D with even H and W."""
    return x.dim() == 4 and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0


def _check(x: torch.Tensor, y: torch.Tensor, dout: torch.Tensor) -> None:
    if not supported(x):
        raise ValueError(f"x must be (N, C, H, W) with even H and W, got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    want = (n, c, h // 2, w // 2)
    for name, t in (("y", y), ("dout", dout)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if y.dtype != x.dtype:
        raise TypeError(f"x and y must have one type, got {x.dtype} and "
                        f"{y.dtype}")


def max_pool2_bwd_plain(x: torch.Tensor, y: torch.Tensor,
                        dout: torch.Tensor) -> torch.Tensor:
    """Plain version of ``max_pool2_bwd_fused``: the first window element
    equal to y (compared in float32, or wider) takes dout, the others 0."""
    _check(x, y, dout)
    n, c, h, w = x.shape
    dout = dout.to(x.dtype)
    wide = torch.promote_types(x.dtype, torch.float32)
    win = x.to(wide).reshape(n, c, h // 2, 2, w // 2, 2)
    win = win.permute(0, 1, 2, 4, 3, 5).reshape(n, c, h // 2, w // 2, 4)
    hit = win == y.to(wide)[..., None]
    first = hit & (torch.cumsum(hit, dim=-1) == 1)
    dx = torch.where(first, dout[..., None], torch.zeros((), dtype=x.dtype))
    dx = dx.reshape(n, c, h // 2, w // 2, 2, 2).permute(0, 1, 2, 4, 3, 5)
    return dx.reshape(n, c, h, w).contiguous(
        memory_format=torch.channels_last)


def max_pool2_bwd_fused(x: torch.Tensor, y: torch.Tensor,
                        dout: torch.Tensor) -> torch.Tensor:
    """Gradient of the 2×2/2 max pool y = pool(x) for the upstream
    gradient ``dout`` (cast to x's type). x is (N, C, H, W) with even H
    and W, y and dout (N, C, H/2, W/2); float32 or bfloat16 on the card
    (any floating type on the CPU). Returns dx of x's shape in
    ``channels_last`` memory."""
    global MAX_POOL2_BWD_LAUNCHES
    _check(x, y, dout)
    if x.device.type == "cpu":
        return max_pool2_bwd_plain(x, y, dout)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    # free for the trunk's channels_last activations; a copy otherwise
    x, y, dout = (t.contiguous(memory_format=torch.channels_last)
                  for t in (x, y, dout.to(x.dtype)))
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return dx
    n, c, h, w = x.shape
    with torch.cuda.device(x.device):
        err = _lib().tfy2_pool2_bwd(
            x.data_ptr(), y.data_ptr(), dout.data_ptr(), dx.data_ptr(), n, h,
            w, c, _DTYPES[x.dtype],
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"tfy2_pool2_bwd launch failed with cudaError_t "
                           f"{err}")
    MAX_POOL2_BWD_LAUNCHES += 1
    return dx


class MaxPool2(torch.autograd.Function):
    """2×2/2 max pool of an NCHW tensor with even H and W: forward
    ``F.max_pool2d``, backward ``max_pool2_bwd_fused``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = F.max_pool2d(x, 2, 2)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dout: torch.Tensor) -> torch.Tensor:
        x, y = ctx.saved_tensors
        return max_pool2_bwd_fused(x, y, dout)
