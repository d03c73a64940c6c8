"""The precision a reference computes in: float32, or the float8 control.

``float32``: every product in float32 with TF32 off, in cuBLAS and cuDNN
alike (``exact_float32`` sets and restores the flags), and no rounding
between operations.

``fp8``: the control, the nearest precision below the bfloat16 compute
the configurations state. Wherever the program holds a tensor in its
compute type (weights cast for use, every product's output, the residual
stream, the activations), the control rounds it to float8 e4m3, and the
gradient that flows back through that point to float8 e5m2, each with one
scale a tensor (its largest magnitude to the format's largest), as float8
training runs. What the program keeps in float32 (LayerNorm statistics,
softmax, the loss) stays float32. Products accumulate in float32.

A reference marks those points with ``Precision.__call__``, which is the
identity in float32.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "fp8")


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under a per-tensor scale, as
    float32."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / torch.finfo(dtype).max,
                        torch.ones_like(amax))
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2)


class Precision:
    """A rounding point: the identity in float32; in the control, float8
    e4m3 forward and e5m2 for the gradient."""

    def __init__(self, name: str):
        if name not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.fp8 = name == "fp8"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.fp8 else x
