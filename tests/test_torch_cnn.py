"""The port's CNN against the JAX package's flax CNN: the same weights (moved
across with ``params_from_jax``) and inputs give the same logits, loss and
gradients."""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vantage6_tpu_torch.models import cnn as tcnn
from vantage6_tpu_torch.workloads import fedavg_mnist as W

jcnn = importlib.import_module("vantage6_tpu.models.cnn")
JW = importlib.import_module("vantage6_tpu.workloads.fedavg_mnist")

# f32 compute on both sides: the same convolutions and matmuls in a
# different summation order, on O(1) activations
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 compute: activations are rounded to bf16 (8 mantissa bits) after
# every conv, pool and dense, in a different order on each side; logits of
# O(1) after four rounded layers agree to a few bf16 ulps (2^-8 each)
BF16_ATOL = 8 * 2.0**-8


@pytest.fixture(scope="module")
def jax_params():
    # jitted: the same values as the eager call, in a third of the time
    return jax.jit(JW.init_params)(jax.random.key(0))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=6).astype(np.int32)
    w = np.asarray([1.0, 0.5, 0.0, 2.0, 1.0, 1.0], np.float32)
    return x, y, w


def loss_f32(params, bx, by, w):
    """``weighted_ce_loss`` with the CNN in f32 compute."""
    logp = torch.log_softmax(tcnn.CNN(compute_dtype=torch.float32)(
        params, bx), dim=-1)
    nll = -torch.gather(logp, 1, by.long()[:, None])[:, 0]
    return torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)


def test_weighted_ce_loss_is_the_loss_in_bf16(jax_params, batch):
    x, y, w = batch
    params = W.params_from_jax(jax_params, "cpu")
    ours = W.weighted_ce_loss(params, torch.from_numpy(x),
                              torch.from_numpy(y), torch.from_numpy(w))
    theirs = JW.weighted_ce_loss(jax_params, jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(w))
    # the mean of bf16-computed logits' cross entropy: a few bf16 ulps
    np.testing.assert_allclose(float(ours), float(theirs), atol=BF16_ATOL)


def _jax_loss(model):
    def loss(params, bx, by, w):
        logits = model.apply({"params": params}, bx)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, by[:, None], axis=1)[:, 0]
        return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1.0)
    return loss


def test_init_params_have_the_jax_names_shapes_and_scale(jax_params):
    ours = W.init_params(torch.Generator().manual_seed(0), device="cpu")
    theirs = jax.tree.map(np.asarray, jax_params)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, theirs))
    for name, fan_in in [("Conv_0", 9), ("Conv_1", 288), ("Dense_0", 3136),
                         ("Dense_1", 128)]:
        k = ours[name]["kernel"]
        assert k.dtype == torch.float32
        assert tuple(k.shape) == theirs[name]["kernel"].shape
        assert torch.equal(ours[name]["bias"], torch.zeros_like(
            ours[name]["bias"]))
        # LeCun normal: variance 1/fan_in, truncated at 2 standard
        # deviations of the untruncated normal
        std = math.sqrt(1.0 / fan_in)
        assert float(k.abs().max()) <= 2 * std / tcnn._TRUNC_STD + 1e-7
        if k.numel() > 1000:
            assert abs(float(k.std()) / std - 1) < 0.05
            assert abs(float(k.std()) / float(np.std(
                theirs[name]["kernel"])) - 1) < 0.05
    again = W.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(ours),
                                                  jax.tree.leaves(again)))


def test_f32_logits_match_jax(jax_params, batch):
    x = batch[0]
    ours = tcnn.CNN(compute_dtype=torch.float32)(
        W.params_from_jax(jax_params, "cpu"), torch.from_numpy(x))
    theirs = jcnn.CNN(compute_dtype=jnp.float32).apply(
        {"params": jax_params}, jnp.asarray(x))
    assert ours.dtype == torch.float32 and ours.shape == (6, 10)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **F32_TOL)


def test_bf16_logits_match_jax(jax_params, batch):
    x = batch[0]
    ours = W.MODEL(W.params_from_jax(jax_params, "cpu"), torch.from_numpy(x))
    theirs = JW.MODEL.apply({"params": jax_params}, jnp.asarray(x))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               atol=BF16_ATOL, rtol=0)


def test_f32_loss_and_grads_match_jax(jax_params, batch):
    x, y, w = batch
    params = W.params_from_jax(jax_params, "cpu")
    grads, loss = torch.func.grad_and_value(loss_f32)(
        params, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w))
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        _jax_loss(jcnn.CNN(compute_dtype=jnp.float32))))(
        jax_params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    np.testing.assert_allclose(float(loss), float(j_loss), **F32_TOL)
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)


def test_cross_entropy_and_accuracy_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(9, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=9).astype(np.int32)
    labels[:3] = logits[:3].argmax(1)
    np.testing.assert_allclose(
        float(tcnn.cross_entropy_loss(torch.from_numpy(logits),
                                      torch.from_numpy(labels))),
        float(jcnn.cross_entropy_loss(jnp.asarray(logits),
                                      jnp.asarray(labels))), rtol=1e-6)
    assert float(tcnn.accuracy(torch.from_numpy(logits),
                               torch.from_numpy(labels))) == float(
        jcnn.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def test_weight_bridge_round_trips(jax_params):
    back = W.params_to_numpy(W.params_from_jax(jax_params, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_params)):
        assert a.dtype == np.float32
        assert np.array_equal(a, np.asarray(b))
