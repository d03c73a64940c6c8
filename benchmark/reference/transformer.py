"""Plain reference of the federated transformer round (the gpt2-medium
configuration), in float32 with TF32 off or in the float8 control
(``reference/precision.py``).

The model is the one the configuration states: GPT-2's decoder (learned
positions, pre-LN blocks, a fused q/k/v projection, causal softmax
attention, a 4x tanh-GELU MLP, a final LayerNorm and logits tied to the
token embedding) with the engine's departures: no biases, LayerNorm without
affine parameters at eps 1e-6 (population variance), no dropout. The loss
is the mean next-token cross-entropy of a station's sequences (T - 1
predictions a sequence).

A round: each station's gradient of its own loss, the plain mean of the
stations' gradients and of their losses (every station takes part, each
weighted 1), and one Adam step with optax's arithmetic. Attention is the
textbook one, the ``[T, T]`` scores materialised and masked; a station's
sequences are taken ``chunk_tokens`` at a time and their gradients summed,
so the reference fits beside nothing else on one card.

Parameters are a dict ``{"embed" [V, d], "pos" [L, d], "layers": [{"qkv"
[d, 3d], "proj" [d, d], "w_up" [d, 4d], "w_down" [4d, d]}, ...]}`` used as
``h @ W``; ``leaves`` walks it in a fixed order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.precision import Precision, exact_float32

LAYER_KEYS = ("qkv", "proj", "w_up", "w_down")
LN_EPS = 1e-6
# the leaf (in ``leaves`` order) used at both ends: the token embedding,
# looked up at the input and tied to the logits
TIED = 0


def leaves(params: dict) -> list[torch.Tensor]:
    """The parameters in a fixed order: embed, pos, then each layer's."""
    out = [params["embed"], params["pos"]]
    for layer in params["layers"]:
        out.extend(layer[k] for k in LAYER_KEYS)
    return out


def rebuild(like: dict, flat: list[torch.Tensor]) -> dict:
    it = iter(flat)
    out = {"embed": next(it), "pos": next(it), "layers": []}
    for _ in like["layers"]:
        out["layers"].append({k: next(it) for k in LAYER_KEYS})
    return out


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS)


def nll_sum(params: dict, tokens: torch.Tensor, n_heads: int,
            rnd: Precision) -> torch.Tensor:
    """Sum of the next-token negative log-likelihoods of ``tokens``
    ``[B, T]``. ``rnd`` marks where the program holds its compute type."""
    b, t = tokens.shape
    d = params["embed"].shape[1]
    dh = d // n_heads
    embed = rnd(params["embed"])
    x = rnd(embed[tokens] + rnd(params["pos"][:t])[None])
    allowed = torch.ones(t, t, dtype=torch.bool,
                         device=tokens.device).tril()
    for layer in params["layers"]:
        w = {k: rnd(layer[k]) for k in LAYER_KEYS}
        q, k, v = rnd(rnd(layer_norm(x)) @ w["qkv"]).split(d, dim=-1)
        q, k, v = (z.reshape(b, t, n_heads, dh).transpose(1, 2)
                   for z in (q, k, v))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
        a = rnd(rnd(p) @ v).transpose(1, 2).reshape(b, t, d)
        x = rnd(x + rnd(a @ w["proj"]))
        up = rnd(rnd(layer_norm(x)) @ w["w_up"])
        x = rnd(x + rnd(rnd(F.gelu(up, approximate="tanh")) @ w["w_down"]))
    logits = rnd(rnd(layer_norm(x)) @ embed.T)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:, None]).sum()


def station_grad(params: dict, tokens: torch.Tensor, n_heads: int,
                 rnd: Precision, chunk_tokens: int
                 ) -> tuple[float, list[torch.Tensor]]:
    """(mean loss, gradient per leaf) of one station's ``[B, T]`` tokens,
    ``chunk_tokens`` at a time."""
    b, t = tokens.shape
    rows = max(1, chunk_tokens // t)
    count = b * (t - 1)
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    tree = rebuild(params, flat)
    grads = [torch.zeros_like(p) for p in flat]
    total = 0.0
    for r0 in range(0, b, rows):
        part = nll_sum(tree, tokens[r0:r0 + rows], n_heads, rnd) / count
        for acc, g in zip(grads, torch.autograd.grad(part, flat),
                          strict=True):
            acc += g
        total += float(part.detach())
    return total, grads


def run(params0: dict, steps: list[torch.Tensor], n_heads: int,
        adam: dict, precision: str = "float32", chunk_tokens: int = 4096
        ) -> dict[str, list]:
    """The rounds of ``steps`` (each ``[S, B, T]`` tokens) from
    ``params0``: each round's loss, the first round's mean gradient and
    the norm of each of its leaves, and the norm of each leaf's change over
    the rounds."""
    rnd = Precision(precision)
    b1, b2, eps, lr = adam["b1"], adam["b2"], adam["eps"], adam["lr"]
    with exact_float32(), torch.no_grad():
        start = [p.detach().clone() for p in leaves(params0)]
        p = [x.clone() for x in start]
        mu = [torch.zeros_like(x) for x in p]
        nu = [torch.zeros_like(x) for x in p]
        losses, grad_norms, first = [], None, None
        for n, tokens in enumerate(steps, start=1):
            tree = rebuild(params0, p)
            g_mean = [torch.zeros_like(x) for x in p]
            loss = 0.0
            for s in range(tokens.shape[0]):
                with torch.enable_grad():
                    l_s, g_s = station_grad(tree, tokens[s], n_heads, rnd,
                                            chunk_tokens)
                loss += l_s / tokens.shape[0]
                for acc, g in zip(g_mean, g_s, strict=True):
                    acc += g / tokens.shape[0]
                del g_s
            losses.append(loss)
            if grad_norms is None:
                grad_norms = [float(torch.linalg.vector_norm(g))
                              for g in g_mean]
                first = [g.clone() for g in g_mean]
            c1 = 1 - b1 ** n
            c2 = 1 - b2 ** n
            for i, g in enumerate(g_mean):
                mu[i] = b1 * mu[i] + (1 - b1) * g
                nu[i] = b2 * nu[i] + (1 - b2) * g * g
                p[i] = p[i] - lr * (mu[i] / c1) / (torch.sqrt(nu[i] / c2)
                                                   + eps)
            del g_mean
        change = [float(torch.linalg.vector_norm(a - b))
                  for a, b in zip(p, start, strict=True)]
    return {"losses": losses, "grad_norms": grad_norms, "grads": first,
            "change_norms": change}
