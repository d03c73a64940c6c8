"""The port's flash attention (PyTorch) against the JAX package's.

The same numpy inputs go through the JAX functions (the Pallas kernel in
interpret mode, ``interpreter_twin``, ``recompute_attention``, the dense
``reference``) and through their PyTorch counterparts on the CPU, where
``flash_attention`` runs the kernel's plain version ``kernel_reference``.
Tolerances: 2e-5 forward and 3e-5 gradients in float32 — the JAX suite's
own (tests/test_flash_attention.py); the two sides sum in other orders.
The card's test (each CUDA kernel against its plain version at that
kernel's tiles) is marked ``cuda`` and skips without a card.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vantage6_tpu_torch.ops import flash_attention as tfa

# the module, not the function that vantage6_tpu.ops re-exports by its name
jfa = importlib.import_module("vantage6_tpu.ops.flash_attention")

F32_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=3e-5, rtol=3e-5)
# bf16 outputs: one bf16 ulp is 2^-8 relative; outputs are O(1) averages,
# and a different f32 summation order can flip a rounding, so allow 2 ulps
BF16_TOL = dict(atol=2 * 2.0**-8, rtol=2 * 2.0**-8)


def rand(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def both(x, dtype="float32"):
    """(jax array, torch tensor) of one numpy array."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [64, 96])  # 96 exercises q/k padding
def test_forward_matches_jax_flash_and_twin(causal, t):
    b, h, d = 2, 3, 16
    (jq, tq), (jk, tk), (jv, tv) = (both(rand((b, h, t, d), s))
                                    for s in (0, 1, 2))
    kw = dict(causal=causal, block_q=32, block_k=32)
    ours = tfa.flash_attention(tq, tk, tv, **kw)
    jax_flash = jfa.flash_attention(jq, jk, jv, interpret=True, **kw)
    twin = jfa.interpreter_twin(jq, jk, jv, **kw)
    np.testing.assert_allclose(np32(ours), np32(jax_flash), **F32_TOL)
    np.testing.assert_allclose(np32(ours), np32(twin), **F32_TOL)
    np.testing.assert_allclose(
        np32(tfa.reference(tq, tk, tv, causal=causal)),
        np32(jfa.reference(jq, jk, jv, causal=causal)), **F32_TOL,
    )


@pytest.mark.parametrize(
    "q_offset,k_offset,t_q,t_k",
    [(32, 0, 32, 64), (4, 0, 100, 100), (32, 32, 32, 32), (40, 8, 24, 56)],
)
def test_offsets_and_ragged_tq_tk(q_offset, k_offset, t_q, t_k):
    """The ring-hop case: Tq != Tk with global-position offsets."""
    b, h, d = 1, 2, 8
    (jq, tq) = both(rand((b, h, t_q, d), 3))
    (jk, tk), (jv, tv) = both(rand((b, h, t_k, d), 4)), both(rand((b, h, t_k, d), 5))
    kw = dict(q_offset=q_offset, k_offset=k_offset, causal=True,
              block_q=16, block_k=16)
    ours = tfa.flash_attention(tq, tk, tv, **kw)
    jax_flash = jfa.flash_attention(jq, jk, jv, interpret=True, **kw)
    np.testing.assert_allclose(np32(ours), np32(jax_flash), **F32_TOL)
    ref = jfa.reference(jq, jk, jv, q_offset=q_offset, k_offset=k_offset,
                        causal=True)
    np.testing.assert_allclose(np32(ours), np32(ref), **F32_TOL)


def test_fully_masked_rows_are_exact_zeros():
    b, h, t, d = 1, 1, 16, 8
    (jq, tq), (jk, tk), (jv, tv) = (both(rand((b, h, t, d), s))
                                    for s in (6, 7, 8))
    kw = dict(q_offset=0, k_offset=1000, causal=True, block_q=16, block_k=16)
    ours = tfa.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_array_equal(ours.numpy(), 0.0)
    np.testing.assert_array_equal(
        np.asarray(jfa.flash_attention(jq, jk, jv, interpret=True, **kw)),
        ours.numpy(),
    )


def test_bf16_forward_matches_jax_flash():
    b, h, t, d = 1, 2, 96, 16
    (jq, tq), (jk, tk), (jv, tv) = (both(rand((b, h, t, d), s), "bfloat16")
                                    for s in (36, 37, 38))
    ours = tfa.flash_attention(tq, tk, tv, causal=True, block_q=32,
                               block_k=32)
    assert ours.dtype == torch.bfloat16
    jax_flash = jfa.flash_attention(jq, jk, jv, causal=True, block_q=32,
                                    block_k=32, interpret=True)
    np.testing.assert_allclose(np32(ours), np32(jax_flash), **BF16_TOL)


@pytest.mark.parametrize(
    "q_offset,k_offset,t_q,t_k",
    # Tq and Tk off the tensor-core kernel's 128 x 64 tiles; a ring hop that
    # leaves key tiles partly visible; keys ahead of queries (fully masked
    # rows)
    [(0, 0, 200, 200), (0, 0, 130, 70), (183, 0, 150, 333), (37, 90, 257, 100)],
)
def test_bf16_kernel_reference_at_tensor_core_tiles(q_offset, k_offset, t_q,
                                                    t_k):
    """The plain version at the tensor-core kernel's tiles rounds p as the
    Pallas kernel and its twin do at the same tiles. Tolerance BF16_TOL, 2
    bf16 ulps: the sides sum in other f32 orders."""
    spec = tfa.KERNELS["tensor_core"]
    b, h, d = 1, 2, 16
    (jq, tq) = both(rand((b, h, t_q, d), 40), "bfloat16")
    (jk, tk), (jv, tv) = (both(rand((b, h, t_k, d), s), "bfloat16")
                          for s in (41, 42))
    kw = dict(q_offset=q_offset, k_offset=k_offset, causal=True,
              block_q=spec.block_q, block_k=spec.block_k)
    ours = tfa.kernel_reference(tq, tk, tv, **kw)
    assert ours.dtype == torch.bfloat16
    jax_flash = jfa.flash_attention(jq, jk, jv, interpret=True, **kw)
    twin = jfa.interpreter_twin(jq, jk, jv, **kw)
    np.testing.assert_allclose(np32(ours), np32(jax_flash), **BF16_TOL)
    np.testing.assert_allclose(np32(ours), np32(twin), **BF16_TOL)


@pytest.mark.parametrize(
    "q_offset,k_offset,t_q,t_k",
    # Tq and Tk off the TF32x3 kernel's 128 x 64 tiles; a ring hop; keys
    # ahead of queries (the first 53 rows fully masked)
    [(0, 0, 200, 200), (0, 0, 130, 70), (183, 0, 150, 333), (37, 90, 257, 100)],
)
def test_f32_kernel_reference_at_tf32x3_tiles(q_offset, k_offset, t_q, t_k):
    """The plain version at the TF32x3 kernel's tiles, in f32, against the
    Pallas kernel in interpret mode; fully masked rows are exact zeros on
    both sides. Tolerance F32_TOL."""
    spec = tfa.KERNELS["tf32x3"]
    b, h, d = 1, 2, 16
    (jq, tq) = both(rand((b, h, t_q, d), 43))
    (jk, tk), (jv, tv) = (both(rand((b, h, t_k, d), s)) for s in (44, 45))
    kw = dict(q_offset=q_offset, k_offset=k_offset, causal=True,
              block_q=spec.block_q, block_k=spec.block_k)
    ours = tfa.kernel_reference(tq, tk, tv, **kw)
    assert ours.dtype == torch.float32
    jax_flash = jfa.flash_attention(jq, jk, jv, interpret=True, **kw)
    np.testing.assert_allclose(np32(ours), np32(jax_flash), **F32_TOL)
    masked = min(t_q, max(0, k_offset - q_offset))  # rows before every key
    np.testing.assert_array_equal(np32(ours)[:, :, :masked], 0.0)
    np.testing.assert_array_equal(np32(jax_flash)[:, :, :masked], 0.0)


@pytest.mark.parametrize(
    "dtype,d,variant",
    [(torch.bfloat16, d, "tensor_core") for d in (16, 32, 64, 128, 256)]
    + [(torch.float32, d, "tf32x3") for d in (8, 16, 32, 64, 128, 256)]
    + [(torch.bfloat16, 8, "tensor_core")],
)
def test_kernel_variant_dispatch(dtype, d, variant):
    """bf16 goes to wgmma and f32 to the tensor cores in three TF32 passes
    (one pass would miss 2e-5), at every D; bf16 at D = 8 (below wgmma's
    k16) runs the D = 16 instantiation on zero-filled columns."""
    assert tfa.kernel_variant(dtype, d) == variant
    spec = tfa.KERNELS[variant]
    assert dtype in spec.dtypes and spec.width(d) in spec.head_dims


def _torch_grads(fn, arrays, loss):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    loss(fn(*ts)).backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["flash", "recompute"])
def test_gradients_match_jax(causal, impl):
    b, h, t, d = 1, 2, 48, 8
    arrays = [rand((b, h, t, d), s) for s in (9, 10, 11)]
    if impl == "flash":
        def jfn(q, k, v):
            return jfa.flash_attention(q, k, v, causal=causal, block_q=16,
                                       block_k=16, interpret=True)

        def tfn(q, k, v):
            return tfa.flash_attention(q, k, v, causal=causal, block_q=16,
                                       block_k=16)
    else:
        def jfn(q, k, v):
            return jfa.recompute_attention(q, k, v, causal=causal, block_k=16)

        def tfn(q, k, v):
            return tfa.recompute_attention(q, k, v, causal=causal, block_k=16)

    g_jax = jax.grad(lambda *a: jnp.sum(jnp.sin(jfn(*a))), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays)
    )
    g_ours = _torch_grads(tfn, arrays, lambda o: torch.sin(o).sum())
    g_dense = _torch_grads(
        lambda q, k, v: tfa.reference(q, k, v, causal=causal), arrays,
        lambda o: torch.sin(o).sum(),
    )
    for go, gj, gd in zip(g_ours, g_jax, g_dense):
        np.testing.assert_allclose(go, np.asarray(gj), **GRAD_TOL)
        np.testing.assert_allclose(go, gd, **GRAD_TOL)


def test_gradients_with_offsets_match_jax():
    b, h, t, d = 1, 1, 32, 8
    arrays = [rand((b, h, t, d), 12), rand((b, h, 2 * t, d), 13),
              rand((b, h, 2 * t, d), 14)]
    kw = dict(q_offset=t, k_offset=0, causal=True, block_q=16, block_k=16)
    g_jax = jax.grad(
        lambda *a: jnp.sum(jfa.flash_attention(*a, interpret=True, **kw) ** 2),
        argnums=(0, 1, 2),
    )(*(jnp.asarray(a) for a in arrays))
    g_ours = _torch_grads(lambda *a: tfa.flash_attention(*a, **kw), arrays,
                          lambda o: (o**2).sum())
    for go, gj in zip(g_ours, g_jax):
        np.testing.assert_allclose(go, np.asarray(gj), **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_bwd_matches_jax(causal):
    """The plain blockwise VJP on identical (q, k, v, o, do), ragged Tk."""
    b, h, t_q, t_k, d = 1, 2, 40, 72, 8
    q, do = rand((b, h, t_q, d), 15), rand((b, h, t_q, d), 16)
    k, v = rand((b, h, t_k, d), 17), rand((b, h, t_k, d), 18)
    o = np.array(jfa.reference(q, k, v, q_offset=32, causal=causal))
    g_jax = jfa._attention_bwd(*(jnp.asarray(x) for x in (q, k, v, o, do)),
                               32, 0, causal, 0.3, block_k=32)
    g_ours = tfa._attention_bwd(*(torch.from_numpy(x) for x in (q, k, v, o, do)),
                                32, 0, causal, 0.3, block_k=32)
    for go, gj in zip(g_ours, g_jax):
        np.testing.assert_allclose(go.numpy(), np.asarray(gj), **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_forward_matches_jax(causal):
    b, h, t, d = 2, 2, 96, 16
    arrays = [rand((b, h, t, d), s) for s in (20, 21, 22)]
    ours = tfa._blockwise_forward(*(torch.from_numpy(a) for a in arrays), 0, 0,
                                  causal=causal, scale=0.25, block_k=32)
    theirs = jfa._blockwise_forward(*(jnp.asarray(a) for a in arrays),
                                    jnp.int32(0), jnp.int32(0), causal=causal,
                                    scale=0.25, block_k=32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **F32_TOL)


def test_unsupported_device_and_shapes_raise():
    q = torch.zeros(1, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfa._flash_forward(q, q, q, 0, 0, False, 1.0, 128, 128)
    x = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_forward_cuda(x, x, x, 0, 0, False, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_forward_cuda(x, x, x, 0, 0, False, 1.0, variant="cuda_core")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the widths a kernel that pads is held at beyond its instantiations: bf16
# at D = 8, real models' 80 and 96, 24, and 12 through the wrapper's pad
PADDED_WIDTHS = (8, 12, 24, 80, 96)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "variant,dtype,d",
    [(variant, dtype, d) for variant, spec in tfa.KERNELS.items()
     for dtype in spec.dtypes
     for d in sorted(set(spec.head_dims)
                     | set(PADDED_WIDTHS if spec.pads else ()))],
)
def test_cuda_kernel_matches_plain_version(cuda, variant, dtype, d):
    """Each kernel against its plain version at the tiles of that kernel
    for the head dim, with a negative scale in the last case."""
    block_q, block_k = tfa.KERNELS[variant].blocks(d)
    g = torch.Generator(device="cpu").manual_seed(d)
    for t_q, t_k, qo, ko, causal, scale in [
            (96, 96, 0, 0, True, d**-0.5), (64, 64, 0, 0, False, d**-0.5),
            (32, 64, 32, 0, True, d**-0.5), (16, 16, 0, 1000, True, d**-0.5),
            (200, 130, 70, 0, True, d**-0.5), (130, 200, 70, 0, True, -0.5)]:
        q = torch.randn(2, 3, t_q, d, generator=g).to(cuda, dtype)
        k = torch.randn(2, 3, t_k, d, generator=g).to(cuda, dtype)
        v = torch.randn(2, 3, t_k, d, generator=g).to(cuda, dtype)
        out = tfa.flash_forward_cuda(q, k, v, qo, ko, causal, scale,
                                     variant=variant)
        plain = tfa.kernel_reference(q, k, v, qo, ko, causal, scale,
                                     block_q, block_k)
        torch.cuda.synchronize()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        np.testing.assert_allclose(np32(out.cpu()), np32(plain.cpu()), **tol)
