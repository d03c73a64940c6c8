"""The bf16 attention backward kernel on the card (``cuda``-marked: the
kernel has no CPU mode, so these skip without a card).

The kernel and the plain recompute ``_attention_bwd`` get the same bf16
(q, k, v, o, dO); both are held to the float64 gradients of dense
attention on the same values. The kernel rounds P and dS to bf16 before
their products (2^-9 relative each), the plain backward keeps them in f32;
both round their outputs to bf16. So the kernel's largest error against
float64 may be up to twice the plain backward's, plus one bf16 ulp (2^-8)
of the largest gradient for the rounding of P and dS summed over the
tiles. Against the plain backward it is held within ``BF16_GRAD_TOL``,
4 bf16 ulps of the largest gradient, as the plain version is on the CPU.

Against its plain version ``backward_reference``, which has the kernel's
tiles and rounding points (the same f32 statistics, P and dS rounded to
bf16 before their products, f32 sums of exact bf16 products, outputs
rounded to bf16), it is held far closer. The two differ only by f32
summation order and the exponential's last bits, which can flip the bf16
rounding of an output (one bf16 ulp of the element, at most 2^-7 of it)
or, rarely, of a P or dS element (``FLIP``: at most 2^-8 of the largest
gradient). The flips are sparse: one-ulp differences on no more than 1/64
of the elements keep the difference's norm within ``PLAIN_NORM`` = 2^-10
of the gradient's, where the f32 ``_attention_bwd``, which rounds P and dS
nowhere, lies about 2.5e-3 away.
"""
import pytest
import torch

from vantage6_tpu_torch.ops import flash_attention as tfa

BF16_GRAD_TOL = 4 * 2.0**-8
ULP = 2.0**-8
FLIP = 2.0**-8
PLAIN_NORM = 2.0**-10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, b, h, t_q, t_k, d, q_offset, k_offset, causal, scale,
            seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, h, t_q, d, generator=g).to(cuda, torch.bfloat16)
    k = torch.randn(b, h, t_k, d, generator=g).to(cuda, torch.bfloat16)
    v = torch.randn(b, h, t_k, d, generator=g).to(cuda, torch.bfloat16)
    do = torch.randn(b, h, t_q, d, generator=g).to(cuda, torch.bfloat16)
    o = tfa.reference(q.float(), k.float(), v.float(), q_offset, k_offset,
                      causal, scale).to(torch.bfloat16)
    return q, k, v, o, do


def _f64_grads(q, k, v, do, q_offset, k_offset, causal, scale):
    """The float64 gradients of dense attention at the bf16 values."""
    q64, k64, v64 = (x.double().requires_grad_() for x in (q, k, v))
    out = tfa.reference(q64, k64, v64, q_offset, k_offset, causal, scale)
    return torch.autograd.grad(out, (q64, k64, v64), do.double())


# (B, H, Tq, Tk, D, q_offset, k_offset, causal, scale or None for
# D^-0.5): both GPT-2 cells' shapes; the widths 16, 32, 80 (on W = 128's
# zero-filled columns) and 128, and 8, 24 and 96 (below a width too), and
# 12 (padded to 16 by the wrapper), with ragged, ring-hop and masked rows;
# a negative scale and scale 0. W = 192: the Moonlight cell's call
# [8, 16, 2048, 192] and a smaller one, 160 and 136 on zero-filled columns,
# 130 (padded to 136), and ragged, ring-hop and masked rows at 160 and 192
SHAPES = [
    (8, 16, 1024, 1024, 64, 0, 0, True, None),
    (64, 16, 128, 128, 64, 0, 0, True, None),
    *((2, 3, 200, 200, d, 0, 0, True, None) for d in (8, 16, 24, 32, 80,
                                                      96, 128)),
    *((2, 3, 130, 70, d, 0, 0, False, None) for d in (16, 32, 80, 128)),
    *((2, 2, 150, 333, d, 183, 0, True, None) for d in (16, 32, 80, 128)),
    *((1, 2, 257, 100, d, 37, 90, True, None) for d in (12, 32, 80, 128)),
    (1, 2, 130, 200, 64, 70, 0, True, -0.2),
    (1, 2, 130, 200, 64, 70, 0, True, 0.0),
    (8, 16, 2048, 2048, 192, 0, 0, True, None),
    (2, 16, 1024, 1024, 192, 0, 0, True, None),
    *((2, 3, 200, 200, d, 0, 0, True, None) for d in (130, 136, 160)),
    *((2, 3, 130, 70, d, 0, 0, False, None) for d in (160, 192)),
    *((2, 2, 150, 333, d, 183, 0, True, None) for d in (160, 192)),
    *((1, 2, 257, 100, d, 37, 90, True, None) for d in (160, 192)),
    (1, 2, 130, 200, 192, 70, 0, True, -0.2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_float64_and_plain(cuda, shape):
    b, h, t_q, t_k, d, qo, ko, causal, scale = shape
    scale = d**-0.5 if scale is None else scale
    q, k, v, o, do = _inputs(cuda, b, h, t_q, t_k, d, qo, ko, causal, scale,
                             d)
    ours = _check_kernel(q, k, v, o, do, qo, ko, causal, scale)
    if causal and ko > qo:  # rows before the first key: exact zeros
        assert (ours[0][:, :, :ko - qo] == 0).all()


@pytest.mark.cuda
def test_kernel_at_mla_widths_gives_zero_dv_columns(cuda):
    """MLA's call (``mla_moe.attend``): q/k 192 wide, v 128 zero-padded to
    192, so o and dO are zero from column 128 too. The W = 192 kernels hold
    to float64 and the plain backward as every row does, and dV's padded
    columns read exactly 0."""
    scale = 192**-0.5
    q, k, v, _, do = _inputs(cuda, 2, 16, 1024, 1024, 192, 0, 0, True,
                             scale, 7)
    v[..., 128:] = 0
    do[..., 128:] = 0
    o = tfa.reference(q.float(), k.float(), v.float(), 0, 0, True,
                      scale).to(torch.bfloat16)
    assert (o[..., 128:] == 0).all()
    before = tfa.flash_backward_cuda.width_launches[192]
    dq, dk, dv = _check_kernel(q, k, v, o, do, 0, 0, True, scale)
    assert tfa.flash_backward_cuda.width_launches[192] == before + 1
    assert (dv[..., 128:] == 0).all()
    assert bool((dv[..., :128] != 0).any())


def _check_kernel(q, k, v, o, do, qo, ko, causal, scale):
    """The kernel's gradients, held to float64, the plain backward and
    ``backward_reference`` on the same inputs."""
    before = tfa.flash_backward_cuda.launches
    ours = tfa.flash_backward_cuda(q, k, v, o, do, qo, ko, causal, scale)
    assert tfa.flash_backward_cuda.launches == before + 1
    plain = tfa._attention_bwd(q, k, v, o, do, qo, ko, causal, scale)
    tiled = tfa.backward_reference(q, k, v, o, do, qo, ko, causal, scale)
    ref = _f64_grads(q, k, v, do, qo, ko, causal, scale)
    torch.cuda.synchronize()
    for name, a, p, t, r in zip("qkv", ours, plain, tiled, ref):
        assert a.shape == p.shape and a.dtype == torch.bfloat16
        assert bool(torch.isfinite(a.float()).all())
        top = r.abs().max().item()
        err = (a.double() - r).abs().max().item()
        err_plain = (p.double() - r).abs().max().item()
        gap = (a.float() - p.float()).abs().max().item()
        assert err <= 2 * err_plain + ULP * top, (name, err, err_plain, top)
        assert gap <= BF16_GRAD_TOL * p.float().abs().max().item(), (
            name, gap)
        # against the plain version that rounds where the kernel rounds
        a, t = a.double(), t.double()
        over = (a - t).abs() - (2.0**-7 * t.abs() + FLIP * t.abs().max())
        assert over.max().item() <= 0, (name, over.max().item())
        assert (a - t).norm() <= PLAIN_NORM * t.norm(), (
            name, ((a - t).norm() / t.norm()).item())
    return ours


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda):
    """No output is summed by more than one block: two calls on the same
    inputs give the same bits."""
    q, k, v, o, do = _inputs(cuda, 8, 16, 1024, 1024, 64, 0, 0, True, 0.125,
                             5)
    first = tfa.flash_backward_cuda(q, k, v, o, do, 0, 0, True, 0.125)
    second = tfa.flash_backward_cuda(q, k, v, o, do, 0, 0, True, 0.125)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wide_kernel_is_deterministic(cuda):
    """The same at W = 192, at the Moonlight cell's call, whose dK/dV
    blocks are two warpgroups that hand P^T from one to the other."""
    scale = 192**-0.5
    q, k, v, o, do = _inputs(cuda, 8, 16, 2048, 2048, 192, 0, 0, True,
                             scale, 5)
    before = tfa.flash_backward_cuda.width_launches[192]
    first = tfa.flash_backward_cuda(q, k, v, o, do, 0, 0, True, scale)
    second = tfa.flash_backward_cuda(q, k, v, o, do, 0, 0, True, scale)
    assert tfa.flash_backward_cuda.width_launches[192] == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_engine_round_launches_the_kernel(cuda):
    """A bf16 transformer round at head dim 64 runs the backward kernel once
    a layer a station (4 stations x 2 layers) and the plain backward on the
    card never."""
    from vantage6_tpu_torch.workloads import fed_transformer as ft

    cfg = ft.TransformerConfig(vocab=512, d_model=128, n_heads=2,
                               n_layers=2, max_len=128, dtype=torch.bfloat16,
                               attention="flash")
    eng = ft.make_engine(n_stations=4, seq_devices=1, cfg=cfg, lr=1e-3)
    tokens = eng.shard_tokens(ft.make_federated_tokens(
        4, batch=2, seq_len=128, vocab=512))
    params, opt = eng.init(torch.Generator().manual_seed(0))
    tfa.flash_backward_cuda.launches = 0
    tfa.flash_backward_cuda.width_launches = dict.fromkeys(
        tfa.BACKWARD_KERNEL.head_dims, 0)
    tfa.flash_backward_cuda.plain_calls = 0
    params, opt, loss = eng.round(params, opt, tokens, torch.ones(4))
    assert torch.isfinite(loss).item()
    assert tfa.flash_backward_cuda.launches == 4 * cfg.n_layers
    assert tfa.flash_backward_cuda.width_launches[64] == 4 * cfg.n_layers
    assert tfa.flash_backward_cuda.plain_calls == 0
