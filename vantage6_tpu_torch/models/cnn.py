"""2-layer CNN — the flagship FedAvg model, in PyTorch.

Counterpart of ``vantage6_tpu/models/cnn.py``: conv 3x3 SAME 32 -> relu ->
avg-pool 2/2 -> conv 3x3 SAME 64 -> relu -> avg-pool 2/2 -> flatten ->
dense 128 -> relu -> dense classes. Activations run in ``compute_dtype``
(bf16 by default), parameters stay float32 and the logits come out float32.

Like flax's module, ``CNN`` holds no weights: it is applied to a parameter
tree, so a station-batched round can map it over per-station parameters.
The tree has the JAX package's names and layouts, so weights cross over as
a plain copy and the flat-packed rows match element for element:

    Conv_0/kernel [3, 3, 1, 32]   (HWIO)     Conv_0/bias [32]
    Conv_1/kernel [3, 3, 32, 64]  (HWIO)     Conv_1/bias [64]
    Dense_0/kernel [3136, 128]    ([in, out]) Dense_0/bias [128]
    Dense_1/kernel [128, 10]                  Dense_1/bias [10]

Inputs and activations are NHWC (``[B, 28, 28, 1]``), so the flatten
before ``Dense_0`` takes the JAX package's feature order. Each 3x3 SAME
convolution is one matrix product: the nine shifted views of the padded
input are concatenated on the channel axis (``[B, H, W, 9*C]``, taps in
(row, column, channel) order, which is the HWIO kernel's own order) and
multiplied by the kernel reshaped to ``[9*C, O]``, both padded with zero
columns and rows to a multiple of 8 so the 1-channel input's K of 9 stays
aligned for the tensor cores. Each 2x2 average pool is a mean over a
reshape. Under ``torch.func.vmap`` over stations with per-station weights
these become batched GEMMs and reductions; ``F.conv2d`` and
``F.avg_pool2d`` would become grouped convolutions (a cuDNN launch per
station, or PyTorch's depthwise kernels for the 1-channel input) and a
slow pooling backward (PERF.md, "Findings").
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal: truncated normal on [-2, 2] standard deviations,
# rescaled to unit variance (the stddev of the standard normal cut there)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(generator: torch.Generator, shape: tuple[int, ...],
                  fan_in: int) -> torch.Tensor:
    """flax's default kernel initialiser: variance 1/fan_in, truncated
    normal, drawn by inverting the normal CDF on a uniform draw."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    hi = 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2) * torch.special.erfinv(2 * (lo + (hi - lo) * u) - 1)
    return (z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(torch.float32)


class CNN(nn.Module):
    """conv(32) -> pool -> conv(64) -> pool -> dense(128) -> dense(classes),
    applied to a parameter tree: ``CNN()(params, x)``."""

    def __init__(self, num_classes: int = 10,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype

    def init(self, generator: torch.Generator,
             image_shape: tuple[int, int, int] = (28, 28, 1)
             ) -> dict[str, Any]:
        """float32 parameters on the CPU: LeCun-normal kernels and zero
        biases, flax's defaults, drawn from ``generator`` (its own stream:
        jax.random cannot be reproduced)."""
        h, w, c = image_shape
        flat = (h // 4) * (w // 4) * 64
        shapes = {"Conv_0": ((3, 3, c, 32), 9 * c),
                  "Conv_1": ((3, 3, 32, 64), 9 * 32),
                  "Dense_0": ((flat, 128), flat),
                  "Dense_1": ((128, self.num_classes), 128)}
        return {name: {"bias": torch.zeros(shape[-1]),
                       "kernel": _lecun_normal(generator, shape, fan_in)}
                for name, (shape, fan_in) in shapes.items()}

    def forward(self, params: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype

        def dense(p, h):
            return h @ p["kernel"].to(dt) + p["bias"].to(dt)

        def conv(p, h):  # 3x3 SAME on NHWC, HWIO kernel
            _, hh, ww, c = h.shape
            hp = F.pad(h, (0, 0, 1, 1, 1, 1))
            taps = torch.cat([hp[:, i:i + hh, j:j + ww]
                              for i in range(3) for j in range(3)], dim=-1)
            k = p["kernel"].reshape(9 * c, -1)
            pad = -(9 * c) % 8
            if pad:
                taps, k = F.pad(taps, (0, pad)), F.pad(k, (0, 0, 0, pad))
            return dense({"kernel": k, "bias": p["bias"]}, taps)

        def pool(h):  # 2x2 average, stride 2, VALID, on NHWC
            b, hh, ww, c = h.shape
            h = h[:, :hh // 2 * 2, :ww // 2 * 2]
            return h.reshape(b, hh // 2, 2, ww // 2, 2, c).mean(dim=(2, 4))

        h = pool(F.relu(conv(params["Conv_0"], x.to(dt))))
        h = pool(F.relu(conv(params["Conv_1"], h)))
        h = h.reshape(h.shape[0], -1)
        h = F.relu(dense(params["Dense_0"], h))
        return dense(params["Dense_1"], h).to(torch.float32)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=1) == labels).to(torch.float32))
