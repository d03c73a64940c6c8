"""The port's flash attention at every head dim the Pallas kernel takes.

The Pallas kernel computes at any D. The port's two tensor-core kernels
serve every head dim: up to 256 they are instantiated at a few widths and a
call runs the next width up on zero-filled columns; above 256 they cut O
into column slabs of at most 256 and sum q.k over depth chunks; the wrapper
zero-pads a D that is not a multiple of 8. Here, on the CPU, the checks
that decide what a CUDA call takes are held to that, and the plain version
``kernel_reference``, at each kernel's tiles for the head dim, is held
against the JAX ``flash_attention(..., interpret=True)`` on the same numpy
inputs at the head dims of real models (Phi-2's 80, Phi-3-mini's 96,
Gemma-2B's 256), at the widths the kernels pad (8, 24), and above 256 (320
and 512, and 300 through the pad), at T up to 256 there. On a card, the
``cuda``-marked cases hold both kernels against their plain versions above
256.

Tolerances: f32 2e-5 forward and 3e-5 gradients, the JAX suite's own
(tests/test_flash_attention.py). bf16 is held to the f32 oracle, the JAX
kernel in f32 on the same bf16-exact inputs: p and the output are rounded
to bf16 (2^-9 relative each) and outputs are O(1), so 2 bf16 ulps, 2^-7.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vantage6_tpu_torch._tree import tree_leaves
from vantage6_tpu_torch.ops import flash_attention as tfa
from vantage6_tpu_torch.workloads import fed_transformer as TT

jfa = importlib.import_module("vantage6_tpu.ops.flash_attention")
JT = importlib.import_module("vantage6_tpu.workloads.fed_transformer")

F32_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=2 * 2.0**-8, rtol=2 * 2.0**-8)

HEAD_DIMS = (8, 24, 80, 96, 256, 300, 320, 512)
CASES = {
    # causal, Tq, Tk, q_offset, k_offset, scale as a multiple of 1/sqrt(D)
    "causal": (True, 200, 200, 0, 0, 1.0),
    "ragged": (False, 130, 70, 0, 0, 1.0),
    "ring_hop": (True, 150, 333, 183, 0, 1.0),
    "keys_ahead": (True, 257, 100, 37, 90, 1.0),  # rows before 90 masked
    "negative_scale": (True, 130, 200, 70, 0, -0.7),
    "zero_scale": (True, 130, 200, 70, 0, 0.0),  # visible p all 1
}
# above 256 the cases at T up to 256, so the interpret runs stay short
WIDE_T = {"ring_hop": (True, 150, 256, 183, 0, 1.0),
          "keys_ahead": (True, 200, 100, 37, 90, 1.0)}


def case_at(d, case):
    return WIDE_T.get(case, CASES[case]) if d > 256 else CASES[case]


def rand(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checks_accept_every_head_dim_and_finite_scale(dtype):
    """Every D and every finite scale goes to the dtype's tensor-core
    kernel: up to 256 at the next instantiated width, above it (257, 320,
    512) in slabs of at most 256 over depth chunks; a scale that is not
    finite raises."""
    variant = tfa.kernel_variant(dtype, 1)
    assert variant == {torch.float32: "tf32x3",
                       torch.bfloat16: "tensor_core"}[dtype]
    for d in range(1, 257):
        assert tfa.kernel_variant(dtype, d) == variant
        for scale in (d**-0.5, -1.5, 0.0, 1e4):
            spec = tfa._check_supported(dtype, d, scale, variant)
        assert spec.width(d) in spec.head_dims and spec.width(d) >= d
        assert spec.split(d) is None
    depth = tfa.KERNELS[variant].depth
    for d, slabs in ((257, (256, 64)), (320, (256, 64)), (512, (256, 256))):
        assert tfa.kernel_variant(dtype, d) == variant
        for scale in (d**-0.5, -1.5, 0.0, 1e4):
            spec = tfa._check_supported(dtype, d, scale, variant)
        assert spec.width(d) == 256
        assert spec.split(d) == (slabs, -(-(d + -d % 8) // depth))
    for bad in (float("inf"), float("nan")):
        with pytest.raises(ValueError, match="finite"):
            tfa._check_supported(dtype, 64, bad, variant)


def test_cuda_core_kernel_keeps_its_widths():
    """The CUDA-core kernel, off the dispatch, takes only the widths it is
    instantiated for."""
    spec = tfa.KERNELS["cuda_core"]
    for d in range(1, 257):
        for dtype in spec.dtypes:
            if d in spec.head_dims:
                tfa._check_supported(dtype, d, 0.5, "cuda_core")
            else:
                with pytest.raises(ValueError, match="cuda_core"):
                    tfa._check_supported(dtype, d, 0.5, "cuda_core")
    with pytest.raises(ValueError, match="unsupported dtype"):
        tfa.kernel_variant(torch.float16, 64)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_kernel_reference_matches_jax_at_each_width(d, case):
    """f32 at the TF32x3 kernel's tiles for D against the Pallas kernel in
    interpret mode at the same tiles; fully masked rows exact zeros."""
    causal, t_q, t_k, qo, ko, factor = case_at(d, case)
    block_q, block_k = tfa.KERNELS["tf32x3"].blocks(d)
    q, k, v = (rand((1, 2, t, d), 100 + d + s)
               for s, t in enumerate((t_q, t_k, t_k)))
    kw = dict(q_offset=qo, k_offset=ko, causal=causal,
              scale=factor * d**-0.5, block_q=block_q, block_k=block_k)
    ours = tfa.kernel_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                **kw)
    theirs = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), interpret=True, **kw))
    np.testing.assert_allclose(ours.numpy(), theirs, **F32_TOL)
    masked = min(t_q, max(0, ko - qo))  # rows before every key
    np.testing.assert_array_equal(ours.numpy()[:, :, :masked], 0.0)
    np.testing.assert_array_equal(theirs[:, :, :masked], 0.0)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bf16_kernel_reference_matches_f32_oracle_at_each_width(d, case):
    """bf16 at the tensor-core kernel's tiles for D against the Pallas
    kernel in f32 on the same bf16-exact inputs."""
    causal, t_q, t_k, qo, ko, factor = case_at(d, case)
    block_q, block_k = tfa.KERNELS["tensor_core"].blocks(d)
    q, k, v = (torch.from_numpy(rand((1, 2, t, d), 200 + d + s))
               .to(torch.bfloat16) for s, t in enumerate((t_q, t_k, t_k)))
    kw = dict(q_offset=qo, k_offset=ko, causal=causal,
              scale=factor * d**-0.5, block_q=block_q, block_k=block_k)
    ours = tfa.kernel_reference(q, k, v, **kw)
    assert ours.dtype == torch.bfloat16
    oracle = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
        interpret=True, **kw))
    np.testing.assert_allclose(ours.float().numpy(), oracle, **BF16_TOL)
    masked = min(t_q, max(0, ko - qo))
    np.testing.assert_array_equal(ours.float().numpy()[:, :, :masked], 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_at_d96_match_jax(causal):
    """Phi-3-mini's head dim through the autograd wrapper (plain forward
    and recompute backward on the CPU) against JAX's VJP of the Pallas
    kernel in interpret mode."""
    b, h, t, d = 1, 2, 48, 96
    arrays = [rand((b, h, t, d), s) for s in (300, 301, 302)]
    kw = dict(causal=causal, block_q=16, block_k=16)
    g_jax = jax.grad(
        lambda *a: jnp.sum(jnp.sin(jfa.flash_attention(*a, interpret=True,
                                                       **kw))),
        argnums=(0, 1, 2),
    )(*(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    torch.sin(tfa.flash_attention(*ts, **kw)).sum().backward()
    for t_, gj in zip(ts, g_jax):
        np.testing.assert_allclose(t_.grad.numpy(), np.asarray(gj),
                                   **GRAD_TOL)


def test_transformer_round_at_d96_matches_jax():
    """One federated round of the transformer at head dim 96 (d_model 192,
    2 heads), station 3 masked, from one JAX init; the JAX round runs the
    Pallas kernel in interpret mode. The loss is held at 1e-6 and the
    aggregated gradient, through Adam's first moment
    mu = (1 - b1) * fed_mean(grads), at rtol 1e-5 and atol 1e-8, the
    tolerances of tests/test_torch_fed_transformer.py."""
    lr, mask = 3e-3, [1.0, 1.0, 1.0, 0.0]
    kw = dict(vocab=32, d_model=192, n_heads=2, n_layers=1, max_len=64)
    jcfg = JT.TransformerConfig(**kw, attention="flash",
                                flash_interpret=True)
    tcfg = TT.TransformerConfig(**kw, attention="flash")
    assert tcfg.head_dim == 96
    tokens = JT.make_federated_tokens(4, batch=2, seq_len=64, vocab=32)
    jeng = JT.make_engine(n_stations=4, seq_devices=1, cfg=jcfg, lr=lr)
    jparams, jopt = jeng.init(jax.random.key(1))
    teng = TT.make_engine(4, 1, tcfg, lr=lr, device="cpu")
    tparams = TT.params_from_jax(jparams, "cpu")
    _, jopt, jloss = jeng.round(jparams, jopt, jeng.shard_tokens(tokens),
                                jnp.asarray(mask))
    _, topt, tloss = teng.round(tparams, teng.optimizer.init(tparams),
                                teng.shard_tokens(tokens),
                                torch.tensor(mask))
    assert np.isfinite(float(tloss))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(jax.tree.leaves(jax.device_get(jopt[0]).mu),
                    tree_leaves(topt.mu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-8)


def test_transformer_round_above_256_matches_jax():
    """The same round at head dim 320 (d_model 640, 2 heads), the width the
    kernels run in slabs of at most 256 on the card; here the plain version
    at the bf16 kernel's tiles against the Pallas kernel in interpret
    mode, at the same tolerances."""
    lr, mask = 3e-3, [1.0, 0.0, 1.0, 1.0]
    kw = dict(vocab=32, d_model=640, n_heads=2, n_layers=1, max_len=64)
    jcfg = JT.TransformerConfig(**kw, attention="flash",
                                flash_interpret=True)
    tcfg = TT.TransformerConfig(**kw, attention="flash")
    assert tcfg.head_dim == 320
    assert tfa.KERNELS["tensor_core"].split(320) == ((256, 64), 3)
    tokens = JT.make_federated_tokens(4, batch=2, seq_len=64, vocab=32)
    jeng = JT.make_engine(n_stations=4, seq_devices=1, cfg=jcfg, lr=lr)
    jparams, jopt = jeng.init(jax.random.key(2))
    teng = TT.make_engine(4, 1, tcfg, lr=lr, device="cpu")
    tparams = TT.params_from_jax(jparams, "cpu")
    _, jopt, jloss = jeng.round(jparams, jopt, jeng.shard_tokens(tokens),
                                jnp.asarray(mask))
    _, topt, tloss = teng.round(tparams, teng.optimizer.init(tparams),
                                teng.shard_tokens(tokens),
                                torch.tensor(mask))
    assert np.isfinite(float(tloss))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(jax.tree.leaves(jax.device_get(jopt[0]).mu),
                    tree_leaves(topt.mu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant,dtype", [("tensor_core", torch.bfloat16),
                                           ("tf32x3", torch.float32)])
@pytest.mark.parametrize("d", (300, 320, 512))
def test_cuda_kernel_above_256_matches_its_twin(cuda, variant, dtype, d):
    """Each tensor-core kernel in slabs against its plain version at its
    tiles (its twin), causal and not, ring-hop offsets, a negative scale
    and fully masked rows; the slabs see one softmax: with V's columns a
    repeat of its first 256, the output's slabs are bit-equal."""
    assert tfa.kernel_variant(dtype, d) == variant
    block_q, block_k = tfa.KERNELS[variant].blocks(d)
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL)["atol"]
    g = torch.Generator(device="cpu").manual_seed(d)
    for case in CASES:
        causal, t_q, t_k, qo, ko, factor = case_at(d, case)
        q, k, v = (torch.randn(2, 3, t, d, generator=g).to(cuda, dtype)
                   for t in (t_q, t_k, t_k))
        scale = factor * d**-0.5
        out = tfa.flash_forward_cuda(q, k, v, qo, ko, causal, scale)
        plain = tfa.kernel_reference(q, k, v, qo, ko, causal, scale,
                                     block_q, block_k)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        assert err <= tol + tol * plain.float().abs().max().item(), case
        masked = min(t_q, max(0, ko - qo))
        assert bool((out[:, :, :masked] == 0).all())
    q, k, v0 = (torch.randn(1, 2, 300, w, generator=g).to(cuda, dtype)
                for w in (d, d, 256))
    v = torch.cat([v0] * (d // 256 + 1), -1)[..., :d].contiguous()
    out = tfa.flash_forward_cuda(q, k, v, 0, 0, True, d**-0.5)
    for s in range(256, d, 256):
        w = min(256, d - s)
        assert torch.equal(out[..., s:s + w], out[..., :w])
