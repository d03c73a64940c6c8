"""The port's CNN against the JAX package's flax CNN: the same weights (moved
across with ``params_from_jax``) and inputs give the same logits, loss and
gradients."""
import functools
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


@functools.cache
def _bf16_gradient_fns():
    """JAX's init and its f32 and bf16 gradients, jitted once."""
    return (jax.jit(JW.init_params),
            jax.jit(jax.grad(_jax_loss(jcnn.CNN(compute_dtype=jnp.float32)))),
            jax.jit(jax.grad(JW.weighted_ce_loss)))


def bf16_gradient_errors(seed: int) -> dict[tuple[str, str], tuple]:
    """(port, JAX) bf16 gradient error of each (layer, leaf) against the
    f32 gradient, as a share of the leaf's largest f32 magnitude, for the
    weights ``init_params(key(seed))`` and 32 examples of
    ``make_federated_data(2, n_per_station=64)`` (station ``seed % 2``,
    rows by ``seed // 2``)."""
    init, grad32, grad16 = _bf16_gradient_fns()
    x, y, _ = JW.make_federated_data(2, n_per_station=64)
    w = np.ones(32, np.float32)
    jax_params = init(jax.random.key(seed))
    rows = slice(32 * (seed // 2 % 2), 32 * (seed // 2 % 2) + 32)
    bx, by = np.asarray(x[seed % 2, rows]), np.asarray(y[seed % 2, rows])
    g32 = grad32(jax_params, bx, by, w)
    j16 = grad16(jax_params, bx, by, w)
    t16 = torch.func.grad(W.weighted_ce_loss)(
        W.params_from_jax(jax_params, "cpu"), torch.from_numpy(bx),
        torch.from_numpy(by), torch.from_numpy(w))
    out = {}
    for name in sorted(jax_params):
        for leaf in ("bias", "kernel"):
            ref = np.asarray(g32[name][leaf])
            scale = np.abs(ref).max()
            out[name, leaf] = tuple(
                float(np.abs(np.asarray(g[name][leaf]) - ref).max() / scale)
                for g in (t16, j16))
    return out


def test_bf16_gradients_are_at_least_as_accurate_as_jax():
    """The bf16 CNN's gradients, held leaf by leaf to the f32 gradient,
    over four JAX-initialised weight sets, each with its own batch of 32.

    JAX's bf16 gradients are not the oracle: XLA:CPU sums each conv bias
    gradient (over batch x height x width) in bf16, while torch accumulates
    its bf16 reductions in f32, so the port's conv bias gradients are the
    more accurate ones (Conv_0's bias error is 0.018-0.046 of its magnitude
    over eight weight sets, JAX's 0.22-0.42). Both are held to the f32
    gradient instead: the error is the largest deviation over the leaf's
    largest f32 magnitude.
    - Conv bias leaves: the port's error is at most JAX's for every set
      (the largest ratio over eight sets was 0.38).
    - Every leaf: the port's error averaged over the sets is at most
      JAX's. On the other leaves both sides round the same activations to
      bf16 at different points, so one set's errors differ either way
      (port over JAX up to 1.36 on Dense_1's kernel, 1.05 on Dense_0's
      bias), while the averages favour the port on every leaf (0.81-0.93
      on the kernels).
    - Every leaf, every set: the error is under 0.1 (0.086 at most)."""
    errors: dict[tuple[str, str], list[tuple[float, float]]] = {}
    for seed in range(4):
        for (name, leaf), (ours, theirs) in bf16_gradient_errors(seed).items():
            assert 0 < ours < 0.1, (seed, name, leaf, ours)
            if name.startswith("Conv") and leaf == "bias":
                assert ours <= theirs, (seed, name, leaf, ours, theirs)
            errors.setdefault((name, leaf), []).append((ours, theirs))
    for (name, leaf), pairs in errors.items():
        ours, theirs = np.mean(pairs, axis=0)
        assert ours <= theirs, (name, leaf, ours, theirs)


if __name__ == "__main__":
    # the readings behind the bf16 gradient test, over eight weight sets:
    # JAX_PLATFORMS=cpu python tests/test_torch_cnn.py
    readings = [bf16_gradient_errors(seed) for seed in range(8)]
    for key in readings[0]:
        ours, theirs = np.asarray([r[key] for r in readings]).T
        print(f"{key[0]}/{key[1]}: port {ours.min():.4f}-{ours.max():.4f}, "
              f"JAX {theirs.min():.4f}-{theirs.max():.4f}, port/JAX max "
              f"{(ours / theirs).max():.3f} mean {(ours / theirs).mean():.3f}"
              f", mean port/mean JAX {ours.mean() / theirs.mean():.3f}")
