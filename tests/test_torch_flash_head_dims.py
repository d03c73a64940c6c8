"""The port's flash attention at every head dim the Pallas kernel takes.

The Pallas kernel computes at any D. The port's two tensor-core kernels are
instantiated at a few widths and serve every head dim from 1 to 256: a
call runs the next width up on zero-filled columns, and the wrapper
zero-pads a D that is not a multiple of 8. Here, on the CPU, the checks
that decide what a CUDA call takes are held to that range, and the plain
version ``kernel_reference``, at each kernel's tiles for the head dim, is
held against the JAX ``flash_attention(..., interpret=True)`` on the same
numpy inputs at the head dims of real models (Phi-2's 80, Phi-3-mini's 96,
Gemma-2B's 256) and at the widths the kernels pad (8, 24).

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

HEAD_DIMS = (8, 24, 80, 96, 256)
CASES = {
    # causal, Tq, Tk, q_offset, k_offset, scale as a multiple of 1/sqrt(D)
    "causal": (True, 200, 200, 0, 0, 1.0),
    "ragged": (False, 130, 70, 0, 0, 1.0),
    "ring_hop": (True, 150, 333, 183, 0, 1.0),
    "keys_ahead": (True, 257, 100, 37, 90, 1.0),  # rows before 90 masked
    "negative_scale": (True, 130, 200, 70, 0, -0.7),
    "zero_scale": (True, 130, 200, 70, 0, 0.0),  # visible p all 1
}


def rand(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checks_accept_every_head_dim_and_finite_scale(dtype):
    """Every D from 1 to 256 and every finite scale goes to the dtype's
    tensor-core kernel; D = 257 and a scale that is not finite raise."""
    variant = tfa.kernel_variant(dtype, 1)
    assert variant == {torch.float32: "tf32x3",
                       torch.bfloat16: "tensor_core"}[dtype]
    for d in range(1, 257):
        assert tfa.kernel_variant(dtype, d) == variant
        for scale in (d**-0.5, -1.5, 0.0, 1e4):
            spec = tfa._check_supported(dtype, d, scale, variant)
        assert spec.width(d) in spec.head_dims and spec.width(d) >= d
    with pytest.raises(ValueError, match="ROADMAP queue 3"):
        tfa._check_supported(dtype, 257, 0.1, variant)
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
    causal, t_q, t_k, qo, ko, factor = CASES[case]
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
    causal, t_q, t_k, qo, ko, factor = CASES[case]
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
