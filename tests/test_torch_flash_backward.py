"""The attention backward's plain version, dispatch and wrapper checks.

``backward_reference`` is the bf16 backward kernel's tiled algorithm in
plain PyTorch (its 64 x 64 tile pairs, causal pairs skipped, P and dS
rounded to the inputs' dtype where they enter a product). In f32 it rounds
nothing, so it is held to the plain recompute ``_attention_bwd`` and to the
JAX package's ``_attention_bwd`` at the JAX suite's gradient tolerance,
3e-5. In bf16 it is held to both within ``BF16_GRAD_TOL`` of the largest
gradient: the plain backwards keep P and dS in f32, the kernel's algorithm
rounds each to bf16 (2^-9 relative) before its product, and both sides
round their outputs to bf16. The card's tests are in
``test_torch_flash_backward_cuda.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vantage6_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("vantage6_tpu.ops.flash_attention")

GRAD_TOL = dict(atol=3e-5, rtol=3e-5)  # the JAX suite's gradient tolerance
# 4 bf16 ulps (2^-8 each) of the largest gradient: the rounding of P and dS
# before their products, summed over up to a few hundred keys or queries,
# plus each side's rounding of its output to bf16 (measured: up to 2^-7)
BF16_GRAD_TOL = 4 * 2.0**-8

# (t_q, t_k, q_offset, k_offset, causal, scale): causal and not, Tq and Tk
# off the 64-row tiles, Tq != Tk, a ring hop that leaves tile pairs partly
# visible, keys ahead of queries (rows before key 90 fully masked), a
# negative scale and scale 0
CASES = [
    (96, 96, 0, 0, False, 0.3),
    (130, 70, 0, 0, True, 0.3),
    (200, 200, 0, 0, True, 0.25),
    (150, 333, 183, 0, True, 0.3),
    (257, 100, 37, 90, True, 0.3),
    (130, 200, 70, 0, True, -0.2),
    (64, 130, 70, 0, True, 0.0),
]


def _inputs(t_q, t_k, q_offset, k_offset, causal, dtype, d=16, seed=0):
    """numpy (q, k, v, o, do) in f32 holding values exact in ``dtype``;
    o is the dense attention of the rounded inputs."""
    rng = np.random.default_rng(seed)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def draw(t):
        x = torch.from_numpy(rng.normal(0, 1, (2, 3, t, d)).astype(np.float32))
        return x.to(tdt).float()

    q, k, v, do = draw(t_q), draw(t_k), draw(t_k), draw(t_q)
    o = tfa.reference(q, k, v, q_offset, k_offset, causal).to(tdt).float()
    return [x.numpy() for x in (q, k, v, o, do)]


def _max_rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_backward_reference_matches_plain_and_jax(case, dtype):
    _check_reference_against_plain_and_jax(case, dtype, 16, relative=False)


@pytest.mark.parametrize("d", [160, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_backward_reference_matches_plain_and_jax_at_the_wide_width(
        case, dtype, d):
    """The W = 192 kernels' tiles are the same 64 x 64 pairs: at head dims
    160 (zero-filled up to 192 on the card) and 192, MLA's q/k width. The
    gradients grow with sqrt(D) (dP sums D products of unit values) to
    about 12, and f32 sums in another order differ in proportion, so in
    f32 the absolute part of ``GRAD_TOL`` is taken of the largest gradient
    here."""
    _check_reference_against_plain_and_jax(case, dtype, d, relative=True)


def _check_reference_against_plain_and_jax(case, dtype, d, relative):
    t_q, t_k, qo, ko, causal, scale = case
    arrays = _inputs(t_q, t_k, qo, ko, causal, dtype, d=d)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    ts = [torch.from_numpy(x).to(tdt) for x in arrays]
    ours = tfa.backward_reference(*ts, qo, ko, causal, scale)
    assert all(g.dtype == tdt for g in ours)
    plain = tfa._attention_bwd(*ts, qo, ko, causal, scale)
    jax = jfa._attention_bwd(*(jnp.asarray(x).astype(jdt) for x in arrays),
                             qo, ko, causal, scale)
    for go, gp, gj in zip(ours, plain, jax):
        go = go.float().numpy()
        gj = np.asarray(jnp.asarray(gj, jnp.float32))
        if dtype == "float32":
            tol = dict(GRAD_TOL)
            if relative:
                tol["atol"] *= max(1.0, float(np.abs(gj).max()))
            np.testing.assert_allclose(go, gp.numpy(), **tol)
            np.testing.assert_allclose(go, gj, **tol)
        else:
            assert _max_rel(go, gp.float().numpy()) <= BF16_GRAD_TOL
            assert _max_rel(go, gj) <= BF16_GRAD_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_offset,k_offset,t_q,t_k", [
    (37, 90, 257, 100),  # rows before key 90 see nothing
    (0, 1000, 40, 40),  # every row fully masked
    (0, 100, 130, 200),  # keys past the last query's position are unseen
])
def test_backward_reference_masked_rows_and_keys_are_exact_zeros(
        dtype, q_offset, k_offset, t_q, t_k):
    """A query that sees no key gets a gradient of exactly 0, and so does a
    key that no query sees, as in the plain backward."""
    arrays = _inputs(t_q, t_k, q_offset, k_offset, True,
                     str(dtype).removeprefix("torch."), seed=1)
    ts = [torch.from_numpy(x).to(dtype) for x in arrays]
    dq, dk, dv = tfa.backward_reference(*ts, q_offset, k_offset, True, 0.3)
    blind_rows = min(t_q, max(0, k_offset - q_offset))
    unseen_from = max(0, min(t_k, q_offset + t_q - k_offset))
    assert blind_rows > 0 or unseen_from < t_k
    assert (dq[:, :, :blind_rows] == 0).all()
    assert (dk[:, :, unseen_from:] == 0).all()
    assert (dv[:, :, unseen_from:] == 0).all()
    plain = tfa._attention_bwd(*ts, q_offset, k_offset, True, 0.3)
    assert (plain[0][:, :, :blind_rows] == 0).all()
    assert (plain[1][:, :, unseen_from:] == 0).all()


def test_backward_reference_tiles_do_not_change_f32_gradients():
    """In f32 the tile pairs and the skipping only reorder f32 sums."""
    arrays = _inputs(200, 150, 60, 0, True, "float32", seed=2)
    ts = [torch.from_numpy(x) for x in arrays]
    at_64 = tfa.backward_reference(*ts, 60, 0, True, 0.3)
    at_16 = tfa.backward_reference(*ts, 60, 0, True, 0.3, block=16)
    for a, b in zip(at_64, at_16):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("device,dtype,d,variant", [
    *(("cuda", torch.bfloat16, d, "tensor_core")
      for d in (1, 8, 12, 16, 24, 32, 64, 80, 96, 128, 129, 160, 192)),
    *(("cuda", torch.bfloat16, d, "plain") for d in (193, 256, 320, 512)),
    *(("cuda", torch.float32, d, "plain") for d in (8, 64, 128, 512)),
    *(("cpu", dt, d, "plain") for dt in (torch.bfloat16, torch.float32)
      for d in (16, 64, 128, 512)),
])
def test_backward_dispatch(device, dtype, d, variant):
    """The kernel serves CUDA bf16 at head dims 1-192 (on its widths 16,
    32, 64, 128 and 192, zero-filled up to them); CPU tensors, f32 (a bf16
    product would be below an f32 configuration's precision) and D > 192
    take the plain recompute."""
    assert tfa.backward_variant(device, dtype, d) == variant
    if variant != "plain":
        spec = tfa.BACKWARD_KERNEL
        assert spec.width(d) in spec.head_dims and spec.width(d) >= d


def _bwd_args(**over):
    x = dict(q=(1, 2, 8, 64), k=(1, 2, 8, 64), v=(1, 2, 8, 64),
             o=(1, 2, 8, 64), do=(1, 2, 8, 64))
    dtype = over.pop("dtype", torch.bfloat16)
    x.update({k: v for k, v in over.items() if k in x})
    return [torch.zeros(s, dtype=dtype) for s in x.values()]


@pytest.mark.parametrize("args,scale,match", [
    (_bwd_args(dtype=torch.float32), 0.125, "takes"),
    (_bwd_args(dtype=torch.float16), 0.125, "takes"),
    (_bwd_args(q=(1, 2, 8, 193), k=(1, 2, 8, 193), v=(1, 2, 8, 193),
               o=(1, 2, 8, 193), do=(1, 2, 8, 193)), 0.1, "head dims 1-192"),
    (_bwd_args(o=(1, 2, 9, 64)), 0.125, "shape mismatch"),
    (_bwd_args(k=(1, 3, 8, 64)), 0.125, "shape mismatch"),
    (_bwd_args(q=(2, 8, 64)), 0.125, r"\[B, H, T, D\]"),
    (_bwd_args(), float("nan"), "finite"),
    (_bwd_args(), 0.125, "CUDA tensor"),
])
def test_backward_wrapper_raises_on_what_the_kernel_does_not_take(
        args, scale, match):
    """The wrapper's checks need no card: a CPU tensor that passes every
    other check is refused last, for its device."""
    with pytest.raises(ValueError, match=match):
        tfa.flash_backward_cuda(*args, 0, 0, True, scale)


def test_cpu_backward_is_plain_and_counts_no_launch():
    """On the CPU the autograd wrapper takes the plain recompute in every
    dtype, and neither the kernel's count nor the plain CUDA count moves."""
    before = (tfa.flash_backward_cuda.launches,
              dict(tfa.flash_backward_cuda.width_launches),
              tfa.flash_backward_cuda.plain_calls)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(1, 2, 40, 16, dtype=dtype).requires_grad_()
                   for _ in range(3))
        out = tfa.flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(out.float().sum(), (q, k, v))
        plain = tfa._attention_bwd(q.detach(), k.detach(), v.detach(),
                                   out.detach(), torch.ones_like(out), 0, 0,
                                   True, 16**-0.5)
        for g, p in zip(grads, plain):
            assert torch.equal(g, p)
    assert (tfa.flash_backward_cuda.launches,
            tfa.flash_backward_cuda.width_launches,
            tfa.flash_backward_cuda.plain_calls) == before
