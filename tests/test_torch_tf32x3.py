"""Why the f32 flash kernel takes three TF32 passes per product.

``vantage6_tpu_torch/ops/csrc/flash_attention_tf32.cu`` runs both products
of f32 attention on the tensor cores, which read only TF32 (10 of f32's 23
mantissa bits) of each operand. This file replays the kernel's arithmetic
in numpy: the split of each operand x into big (x rounded to TF32, to
nearest, ties away) and small = x - big, read truncated to TF32 as the
tensor cores read it, and each product as big*small + small*big + big*big
in f32. It holds the emulated kernel, over key tiles of the kernel's own
size with its online softmax, against the JAX package's dense reference at
every head dim the kernel takes, causal and not, to the reference suite's
forward tolerance, 2e-5 + 2e-5 * max|out|: three passes stay inside it and
one pass (both operands rounded to TF32) does not.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from vantage6_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("vantage6_tpu.ops.flash_attention")

TOL = 2e-5  # tests/test_flash_attention.py's forward tolerance
MASK = np.uint32(0xFFFFE000)  # the 19 bits of a TF32 operand
HALF_ULP = np.uint32(0x1000)  # half a TF32 ulp, in f32 bits


def tf32_trunc(x):
    """x as the tensor cores read it: the low 13 mantissa bits dropped."""
    return (np.asarray(x, np.float32).view(np.uint32) & MASK).view(np.float32)


def tf32_round(x):
    """x rounded to TF32, to nearest with ties away from zero (cvt.rna):
    the kernel adds half a TF32 ulp to the bits and lets the tensor cores
    truncate."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return tf32_trunc((bits + HALF_ULP).view(np.float32))


def split(x):
    """(big, small) as the tensor cores read them; x - big is exact."""
    big = tf32_round(x)
    return big, tf32_trunc(np.float32(x) - big)


def matmul(a, b, passes):
    """a @ b as the kernel computes it, f32 accumulation: three passes, the
    small terms first, or one pass on operands rounded to TF32."""
    if passes == 1:
        return tf32_round(a) @ tf32_round(b)
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return (a_big @ b_small + a_small @ b_big) + a_big @ b_big


def emulated_kernel(q, k, v, causal, passes):
    """One head, [T, D] f32: the kernel's online softmax over key tiles of
    its own size, scores in log2 units, masked scores -inf, the running max
    floored at -1e20, p kept in f32, output acc / l."""
    block_k = tfa.KERNELS["tf32x3"].block_k
    t_q, d = q.shape
    t_k = k.shape[0]
    scale_log2 = np.float32(d**-0.5 * np.log2(np.e))
    m = np.full((t_q, 1), np.float32(-1e30))
    l = np.zeros((t_q, 1), np.float32)
    acc = np.zeros((t_q, d), np.float32)
    rows = np.arange(t_q)[:, None]
    for k0 in range(0, t_k, block_k):
        cols = k0 + np.arange(min(block_k, t_k - k0))[None, :]
        s = matmul(q, k[k0:k0 + block_k].T, passes) * scale_log2
        if causal:
            s = np.where(rows >= cols, s, np.float32(-np.inf))
        m_new = np.maximum(np.maximum(m, s.max(1, keepdims=True)),
                           np.float32(-1e20 * np.log2(np.e)))
        corr = np.exp2(m - m_new)
        p = np.exp2(s - m_new).astype(np.float32)
        l = l * corr + p.sum(1, keepdims=True)
        acc = acc * corr + matmul(p, v[k0:k0 + block_k], passes)
        m = m_new
    return acc / np.where(l > 0, l, np.float32(1))


def errors(d, causal, passes):
    """(max |kernel - reference|, tolerance) over [1, 2, 512, d] inputs."""
    rng = np.random.default_rng(d + 1000 * causal)
    q, k, v = (rng.standard_normal((1, 2, 512, d)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jfa.reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal))
    out = np.stack([emulated_kernel(q[0, i], k[0, i], v[0, i], causal,
                                    passes) for i in range(2)])[None]
    return np.abs(out - ref).max(), TOL + TOL * np.abs(ref).max()


HEAD_DIMS = tfa.KERNELS["tf32x3"].head_dims


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_three_tf32_passes_keep_the_f32_tolerance(d, causal):
    err, tol = errors(d, causal, passes=3)
    assert err <= tol / 10, (err, tol)  # an order of magnitude to spare


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_one_tf32_pass_misses_the_f32_tolerance(d, causal):
    err, tol = errors(d, causal, passes=1)
    assert err > 2 * tol, (err, tol)


def test_split_rounds_to_nearest_and_loses_under_2_to_the_minus_21():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000)
         * np.exp2(rng.integers(-30, 30, 100_000))).astype(np.float32)
    big, small = split(x)
    # big is x rounded to 11 significant bits, to nearest, ties away
    frac, exp = np.frexp(x.astype(np.float64))
    want = np.ldexp(np.sign(frac) * np.floor(np.abs(frac) * 2**11 + 0.5)
                    / 2**11, exp)
    np.testing.assert_array_equal(big.astype(np.float64), want)
    # what the tensor cores read of big + small is x to 2^-21
    lost = np.abs(x.astype(np.float64) - big - small.astype(np.float64))
    assert (lost <= np.abs(x) * 2.0**-21).all()
    # a tie rounds away from zero
    tie = np.float32(1 + 2**-11)
    assert tf32_round(tie) == np.float32(1 + 2**-10)
    assert tf32_round(-tie) == -np.float32(1 + 2**-10)
