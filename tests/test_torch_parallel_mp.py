"""The port's per-rank ring attention and tensor parallelism across two
and four gloo ranks on the CPU, held to their one-process forms.

Each rank holds its sequence shard (the ring) or its weight blocks (TP);
the one-process oracles are ``ring_attention_sharded`` at the same P
(held to the JAX package's ring in ``tests/test_torch_parallel.py``) and
the dense MLP. Gradients go through the ring's send/recv autograd
function and TP's all-reduces; TP's backward rule gives the dense MLP's
gradient (``parallel/tensor.py``).
"""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_distributed import run_ranks

TR = importlib.import_module("vantage6_tpu_torch.parallel.ring_attention")

FWD_TOL = 2e-5  # tests/test_torch_parallel.py
GRAD_TOL = 5e-4
TP_TOL = 1e-5

B, T, H, D = 2, 16, 2, 8
D_MODEL, D_FF = 8, 32


def _ring_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, T, H, D))
                             .astype(np.float32)) for _ in range(4)]


def _tp_inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D_MODEL)).astype(np.float32)
    up = (rng.standard_normal((D_MODEL, D_FF)) / np.sqrt(D_MODEL)).astype(
        np.float32)
    down = (rng.standard_normal((D_FF, D_MODEL)) / np.sqrt(D_FF)).astype(
        np.float32)
    g = rng.standard_normal((B, T, D_MODEL)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, up, down, g)]


_BODY = """
import importlib
from vantage6_tpu_torch.parallel import tensor as TP
R = importlib.import_module("vantage6_tpu_torch.parallel.ring_attention")
group = torch.distributed.group.WORLD
inputs = torch.load(f"{sys.argv[4]}/inputs.pt")
t = inputs["ring"][0].shape[1] // world
for causal in (False, True):
    q, k, v, g = (x[:, rank * t:(rank + 1) * t] for x in inputs["ring"])
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = R.ring_attention(q, k, v, group, causal=causal)
    (out * g).sum().backward()
    res[f"ring_{causal}"] = (out.detach(), q.grad, k.grad, v.grad)

x, up, down, g = inputs["tp"]
f = up.shape[1] // world
x = x.clone().requires_grad_()
up = up[:, rank * f:(rank + 1) * f].clone().requires_grad_()
down = down[rank * f:(rank + 1) * f].clone().requires_grad_()
out = TP.tp_mlp(x, up, down, group=group)
(out * g).sum().backward()
res["tp"] = (out.detach(), x.grad, up.grad, down.grad)
"""


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"P{n}")
def ranks(request, tmp_path_factory):
    """Every rank's results at P = 2 and at P = 4: at P = 2 the ranks
    before and after a rank are the same one, so only P = 4 tells a ring
    turned the wrong way, or a backward that sends forward, apart."""
    tmp = tmp_path_factory.mktemp(f"parallel{request.param}")
    torch.save({"ring": _ring_inputs(), "tp": _tp_inputs()},
               tmp / "inputs.pt")
    return run_ranks(tmp, _BODY, n=request.param)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_across_ranks_matches_the_stacked_ring(ranks, causal):
    q, k, v, g = _ring_inputs()
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    n = len(ranks)
    ref = TR.ring_attention_sharded(q, k, v, n, causal=causal)
    (ref * g).sum().backward()
    t = T // n
    for r, out in enumerate(ranks):
        got, gq, gk, gv = out[f"ring_{causal}"]
        rows = slice(r * t, (r + 1) * t)
        torch.testing.assert_close(got, ref.detach()[:, rows], rtol=0,
                                   atol=FWD_TOL)
        for mine, full in ((gq, q.grad), (gk, k.grad), (gv, v.grad)):
            torch.testing.assert_close(mine, full[:, rows], rtol=0,
                                       atol=GRAD_TOL)


def test_tp_mlp_across_ranks_has_the_dense_gradient(ranks):
    x, up, down, g = _tp_inputs()
    x, up, down = (a.clone().requires_grad_() for a in (x, up, down))
    ref = F.gelu(x @ up, approximate="tanh") @ down
    (ref * g).sum().backward()
    f = D_FF // len(ranks)
    for r, out in enumerate(ranks):
        got, gx, gup, gdown = out["tp"]
        torch.testing.assert_close(got, ref.detach(), rtol=0, atol=TP_TOL)
        # the input's gradient is all-reduced: the dense one, on each rank
        torch.testing.assert_close(gx, x.grad, rtol=0, atol=TP_TOL)
        torch.testing.assert_close(gup, up.grad[:, r * f:(r + 1) * f],
                                   rtol=0, atol=TP_TOL)
        torch.testing.assert_close(gdown, down.grad[r * f:(r + 1) * f],
                                   rtol=0, atol=TP_TOL)
    # the all-reduced output is replicated: identical on every rank
    for out in ranks[1:]:
        assert torch.equal(ranks[0]["tp"][0], out["tp"][0])
        assert torch.equal(ranks[0]["tp"][1], out["tp"][1])
