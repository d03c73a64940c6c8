"""Plain reference of the FedAvg-CNN round (the cnn-flagship
configuration), in float32 with TF32 off or in the float8 control
(``reference/precision.py``).

The model is the flagship's CNN: 3x3 SAME convolution to 32 channels,
ReLU, 2x2 average pool, 3x3 SAME convolution to 64, ReLU, pool, flatten
(height, width, channel order), dense 128, ReLU, dense 10; kernels in HWIO
and ``[in, out]`` layouts. All stations run at once: their convolutions as
one grouped convolution, their dense layers as batched products.

A round: each station runs ``local_steps`` of minibatch SGD on its own
examples from the global parameters (mean cross-entropy of the batch), its
delta is the change; the server takes the count-weighted mean of the
deltas (with compression, of what it reconstructs from each station's
compressed delta) and adds it to the parameters (FedAvg: ``sgd(1.0)`` on
the negative mean delta). The round's loss is the count-weighted mean of
the stations' mean losses over their steps.

Compression (top-k with int8 codes and error feedback): each station adds
its error-feedback carry to its flat delta (leaves in ``LEAVES`` order),
keeps the ``round(ratio * n)`` largest magnitudes (ties to the lower
index), codes every value as ``floor(x / scale + u)`` clipped to [-127,
127] with one scale, the chunk's largest magnitude over 127, a chunk of
``chunk`` values, and ships the kept codes; the server reconstructs
``code * scale`` at the kept positions and zero elsewhere, and the station
carries ``acc - reconstruction`` to the next round.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.precision import Precision, exact_float32

# the flat-pack order: layer names, then bias before kernel
LEAVES = (("Conv_0", "bias"), ("Conv_0", "kernel"), ("Conv_1", "bias"),
          ("Conv_1", "kernel"), ("Dense_0", "bias"), ("Dense_0", "kernel"),
          ("Dense_1", "bias"), ("Dense_1", "kernel"))


def leaves(params: dict) -> list[torch.Tensor]:
    return [params[layer][name] for layer, name in LEAVES]


def rebuild(flat: list[torch.Tensor]) -> dict:
    out: dict = {}
    for (layer, name), x in zip(LEAVES, flat, strict=True):
        out.setdefault(layer, {})[name] = x
    return out


def _conv(rnd: Precision, h: torch.Tensor, layer: dict) -> torch.Tensor:
    """3x3 SAME convolution of every station at once: ``h`` ``[B, S*C, H,
    W]``, per-station HWIO kernels ``[S, 3, 3, C, O]``."""
    s, _, _, c, o = layer["kernel"].shape
    w = rnd(layer["kernel"]).permute(0, 4, 3, 1, 2).reshape(s * o, c, 3, 3)
    out = rnd(F.conv2d(h, w, padding=1, groups=s))
    return rnd(out + rnd(layer["bias"]).reshape(1, -1, 1, 1))


def _dense(rnd: Precision, h: torch.Tensor, layer: dict) -> torch.Tensor:
    out = rnd(h @ rnd(layer["kernel"]))
    return rnd(out + rnd(layer["bias"])[:, None])


def logits(p: dict, x: torch.Tensor, rnd: Precision) -> torch.Tensor:
    """``[S, B, classes]`` of per-station parameters (leading ``S``) on
    per-station images ``x`` ``[S, B, H, W, C]``; ``rnd`` marks where the
    program holds its compute type."""
    s, b, hh, ww, c = x.shape
    h = rnd(x.permute(1, 0, 4, 2, 3).reshape(b, s * c, hh, ww))
    h = rnd(F.avg_pool2d(F.relu(_conv(rnd, h, p["Conv_0"])), 2))
    h = rnd(F.avg_pool2d(F.relu(_conv(rnd, h, p["Conv_1"])), 2))
    _, _, h7, w7 = h.shape
    h = h.reshape(b, s, -1, h7, w7).permute(1, 0, 3, 4, 2).reshape(s, b, -1)
    return _dense(rnd, F.relu(_dense(rnd, h, p["Dense_0"])), p["Dense_1"])


def local_training(params: dict, x: torch.Tensor, y: torch.Tensor,
                   idx: torch.Tensor, lr: float, rnd: Precision
                   ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Every station's local steps from ``params``: (delta per leaf
    ``[S, ...]``, each station's mean loss over its steps ``[S]``)."""
    s, steps, _ = idx.shape
    start = [t.expand(s, *t.shape).clone() for t in leaves(params)]
    p = [t.clone() for t in start]
    rows = torch.arange(s, device=x.device)[:, None]
    losses = []
    for step in range(steps):
        bx, by = x[rows, idx[:, step]], y[rows, idx[:, step]].long()
        flat = [t.requires_grad_() for t in p]
        with torch.enable_grad():
            logp = torch.log_softmax(logits(rebuild(flat), bx, rnd), dim=-1)
            nll = -torch.gather(logp, -1, by[..., None])[..., 0].mean(-1)
            grads = torch.autograd.grad(nll.sum(), flat)
        p = [t.detach() - lr * g for t, g in zip(flat, grads, strict=True)]
        losses.append(nll.detach())
    return ([a - b for a, b in zip(p, start, strict=True)],
            torch.stack(losses).mean(0))


def compress(acc: torch.Tensor, noise: torch.Tensor, ratio: float,
             chunk: int) -> torch.Tensor:
    """What the server reconstructs of each row of ``acc`` ``[S, n]``
    under top-k with int8 codes (``noise`` ``[S, n_pad]`` uniforms)."""
    s, n = acc.shape
    k = max(1, min(n, int(round(ratio * n))))
    c = math.ceil(n / chunk)
    padded = F.pad(acc, (0, c * chunk - n)).reshape(s, c, chunk)
    scale = padded.abs().amax(-1) / 127.0
    div = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    code = torch.where(scale[..., None] > 0, padded / div,
                       torch.zeros_like(padded))
    code = torch.clamp(torch.floor(code + noise.reshape(s, c, chunk)),
                       -127, 127)
    value = (code * scale[..., None]).reshape(s, c * chunk)[:, :n]
    order = torch.sort(acc.abs(), dim=-1, descending=True,
                       stable=True).indices[:, :k]
    out = torch.zeros_like(acc)
    return out.scatter_(-1, order, torch.gather(value, -1, order))


def run(params0: dict, x: torch.Tensor, y: torch.Tensor,
        counts: torch.Tensor, steps: list[dict], spec: dict,
        precision: str = "float32") -> dict[str, list]:
    """The rounds of ``steps`` (each ``{"idx" [S, L, B], "noise" [S,
    n_pad] or None}``) from ``params0``: each round's loss, the first
    round's pseudo-gradient (the negative mean delta) and the norm of each
    of its leaves, the norm of each leaf's change over the rounds, and of each station's
    first update (as the server reconstructs it)."""
    rnd = Precision(precision)
    w = counts / counts.sum()
    comp = spec.get("compressor")
    with exact_float32(), torch.no_grad():
        p = [t.detach().clone() for t in leaves(params0)]
        start = [t.clone() for t in p]
        ef = station_norms = None
        losses, grad_norms, first = [], None, None
        for step in steps:
            deltas, station_loss = local_training(
                rebuild(p), x, y, step["idx"], spec["local_lr"], rnd)
            flat = torch.cat([d.reshape(d.shape[0], -1) for d in deltas],
                             dim=1)
            if comp is not None:
                acc = flat if ef is None else flat + ef
                flat = compress(acc, step["noise"], comp["topk_ratio"],
                                comp["chunk"])
                ef = acc - flat
                sizes = [d[0].numel() for d in deltas]
                deltas = [h.reshape(d.shape) for h, d in zip(
                    flat.split(sizes, dim=1), deltas, strict=True)]
            if station_norms is None:  # of what the server reconstructs
                station_norms = torch.linalg.vector_norm(flat, dim=1).tolist()
            mean = [torch.tensordot(w, d, dims=1) for d in deltas]
            losses.append(float(torch.dot(w, station_loss)))
            if grad_norms is None:
                first = [-m for m in mean]
                grad_norms = [float(torch.linalg.vector_norm(m))
                              for m in mean]
            p = [a + m for a, m in zip(p, mean, strict=True)]
        change = [float(torch.linalg.vector_norm(a - b))
                  for a, b in zip(p, start, strict=True)]
    return {"losses": losses, "grad_norms": grad_norms, "grads": first,
            "change_norms": change, "station_norms": station_norms}
