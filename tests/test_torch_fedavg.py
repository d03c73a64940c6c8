"""The port's FedAvg engine against the JAX package's, in f32 on the CPU.

Both sides start from the same JAX-initialised CNN weights and train on the
same shards. The JAX engine draws its batch indices with jax.random
(``fold_in(round_key, station)`` -> ``split(local_steps)`` ->
``randint(0, max(count, 1))``); the tests recompute those draws and inject
them into the port through ``batch_idx``. Counts are ragged and include an
empty station, and one station is masked out.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vantage6_tpu_torch._tree import tree_leaves, tree_map
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed import fedavg as tf
from vantage6_tpu_torch.fed.collectives import fed_mean
from vantage6_tpu_torch.models.cnn import CNN
from vantage6_tpu_torch.optim import adam, sgd
from vantage6_tpu_torch.utils.datasets import synthetic_image_classes
from vantage6_tpu_torch.workloads import fedavg_mnist as W

JW = importlib.import_module("vantage6_tpu.workloads.fedavg_mnist")
jf = importlib.import_module("vantage6_tpu.fed.fedavg")
jcnn = importlib.import_module("vantage6_tpu.models.cnn")
JaxMesh = importlib.import_module("vantage6_tpu.core.mesh").FederationMesh

S, N_PER, L, B, LR, K = 4, 8, 2, 4, 0.05, 3
MASK = np.asarray([1.0, 1.0, 0.0, 1.0], np.float32)  # station 2 dropped
# f32 on both sides; params after up to 3 rounds of 2 local SGD steps
TOL = dict(rtol=1e-5, atol=1e-6)
# Adam divides each entry by sqrt(v): where a round's mean delta is near
# zero against f32 rounding, the two sides step that entry by different
# shares of lr (1e-3); held to 5% of lr
ADAM_TOL = dict(rtol=1e-4, atol=5e-5)
# learning stats: cosines of f32 deltas, near-zero norms included
STATS_TOL = dict(rtol=1e-4, atol=2e-5)

_JM32 = jcnn.CNN(compute_dtype=jnp.float32)
_TM32 = CNN(compute_dtype=torch.float32)


def _jax_loss(params, bx, by, w):
    logits = _JM32.apply({"params": params}, bx)
    logp = jax.nn.log_softmax(logits)
    nll = -jnp.take_along_axis(logp, by[:, None], axis=1)[:, 0]
    return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1.0)


def _jax_engine(**kw):
    return jf.FedAvg(
        JaxMesh(S, devices=jax.devices()[:1]),
        jf.FedAvgSpec(loss_fn=_jax_loss, local_steps=L, batch_size=B,
                      local_lr=LR, local_unroll=True, **kw),
    )


def _loss_f32(params, bx, by, w):
    """``W.weighted_ce_loss`` with the CNN in f32 compute."""
    logp = torch.log_softmax(_TM32(params, bx), dim=-1)
    nll = -torch.gather(logp, 1, by.long()[:, None])[:, 0]
    return torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)


def _engine(**kw):
    return tf.FedAvg(
        FederationMesh(S, device="cpu"),
        tf.FedAvgSpec(loss_fn=_loss_f32, local_steps=L, batch_size=B,
                      local_lr=LR, **kw),
    )


def _draws(round_key, counts):
    """The JAX engine's batch indices for one round: [S, L, B]."""
    out = []
    for sid, c in enumerate(np.asarray(counts)):
        keys = jax.random.split(jax.random.fold_in(round_key, sid), L)
        out.append([np.asarray(jax.random.randint(k, (B,), 0, max(int(c), 1)))
                    for k in keys])
    return np.asarray(out)


def _close(ours, theirs, **tol):
    ours, theirs = tree_leaves(ours), jax.tree.leaves(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.fixture(scope="module")
def data():
    jx, jy, jcounts = JW.make_federated_data(S, n_per_station=N_PER)
    x, y, counts = W.make_federated_data(S, n_per_station=N_PER)
    return (jx, jy, jcounts), (x, y, counts)


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(JW.init_params)(jax.random.key(0))


def test_federated_data_is_the_jax_packages(data):
    (jx, jy, jcounts), (x, y, counts) = data
    assert np.array_equal(x.numpy(), np.asarray(jx))
    assert np.array_equal(y.numpy(), np.asarray(jy))
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    # ragged, one station empty: the cases the weighting must get right
    assert counts.tolist() == [0.0, 3.0, 13.0, 16.0]
    assert x.shape[1] <= 32


@pytest.mark.parametrize("sid", [0, 3])
def test_local_update_matches_jax(data, jax_params, sid):
    (jx, jy, jcounts), (x, y, _) = data
    round_key = jax.random.key(11)
    idx = _draws(round_key, jcounts)
    assert (idx < np.maximum(np.asarray(jcounts), 1)[:, None, None]).all()
    j_delta, j_loss = jax.jit(_jax_engine()._local_update)(
        jx[sid], jy[sid], jcounts[sid], jnp.int32(sid), jax_params, round_key)
    delta, loss = _engine()._local_update(
        x[sid], y[sid], torch.from_numpy(idx[sid]),
        W.params_from_jax(jax_params, "cpu"))
    _close(delta, j_delta, **TOL)
    np.testing.assert_allclose(float(loss), float(j_loss), **TOL)


OPTIMIZERS = {
    "sgd": (lambda: None, lambda: None, False, None, TOL),
    "adam": (lambda: adam(1e-3), lambda: optax.adam(1e-3), False, None,
             ADAM_TOL),
    "sharded_sgd": (lambda: None, lambda: None, True, None, TOL),
    "sharded_adam_bf16_wire": (lambda: adam(1e-3), lambda: optax.adam(1e-3),
                               True, "bfloat16", ADAM_TOL),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_rounds_match_jax(data, jax_params, name):
    t_opt, j_opt, shard, wire, tol = OPTIMIZERS[name]
    (jx, jy, jcounts), (x, y, counts) = data
    jeng = _jax_engine(server_optimizer=j_opt(), shard_server_update=shard,
                       comm_dtype=None if wire is None else getattr(jnp, wire))
    eng = _engine(server_optimizer=t_opt(), shard_server_update=shard,
                  comm_dtype=None if wire is None else getattr(torch, wire))
    jp, js = jax_params, jeng.init(jax_params)
    p = W.params_from_jax(jax_params, "cpu")
    s = eng.init(p)
    for k, round_key in enumerate(jax.random.split(jax.random.key(5), K)):
        jp, js, j_loss, j_stats = jeng.round(jp, js, jx, jy, jcounts,
                                             round_key, mask=jnp.asarray(MASK))
        p, s, loss, stats = eng.round(p, s, x, y, counts, mask=MASK,
                                      batch_idx=_draws(round_key, jcounts))
        if k in (0, K - 1):
            _close(p, jp, **tol)
        np.testing.assert_allclose(float(loss), float(j_loss), **TOL)
        assert sorted(stats) == sorted(j_stats)
        _close([stats[n] for n in sorted(stats)],
               [j_stats[n] for n in sorted(j_stats)], **STATS_TOL)
    _close(s, js, **tol)


@pytest.mark.parametrize("per_round", [False, True])
def test_run_rounds_matches_jax(data, jax_params, per_round):
    (jx, jy, jcounts), (x, y, counts) = data
    mask = (np.stack([MASK, np.ones(S, np.float32), MASK[::-1]])
            if per_round else MASK)
    key = jax.random.key(7)
    jp, _, j_losses, j_stats = _jax_engine().run_rounds(
        jax_params, jx, jy, jcounts, key, K, mask=jnp.asarray(mask),
        donate=False, unroll=True)
    idx = np.stack([_draws(k, jcounts) for k in jax.random.split(key, K)])
    p, _, losses, stats = _engine().run_rounds(
        W.params_from_jax(jax_params, "cpu"), x, y, counts, None, K,
        mask=mask, batch_idx=idx)
    _close(p, jp, **TOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses), **TOL)
    assert stats["station_cos"].shape == (K, S)
    for n in j_stats:
        np.testing.assert_allclose(stats[n].numpy(), np.asarray(j_stats[n]),
                                   **STATS_TOL)


def test_run_rounds_async_matches_jax(data, jax_params):
    (jx, jy, jcounts), (x, y, counts) = data
    accept = np.asarray([[1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 0, 1]],
                        np.float32)
    stale0 = np.asarray([0.0, 2.0, 1.0, 0.0], np.float32)
    spec_kw = dict(quorum=2, staleness_discount=0.5)
    key = jax.random.key(9)
    jp, _, j_stale, j_losses, _ = _jax_engine().run_rounds_async(
        jax_params, jx, jy, jcounts, key, K, jnp.asarray(accept),
        jf.AsyncRoundSpec(**spec_kw), staleness=jnp.asarray(stale0),
        donate=False)
    idx = np.stack([_draws(k, jcounts) for k in jax.random.split(key, K)])
    p, _, stale, losses, _ = _engine().run_rounds_async(
        W.params_from_jax(jax_params, "cpu"), x, y, counts, None, K, accept,
        tf.AsyncRoundSpec(**spec_kw), staleness=stale0, batch_idx=idx)
    assert np.array_equal(stale.numpy(), np.asarray(j_stale))
    assert stale.tolist() == [0.0, 0.0, 1.0, 0.0]
    _close(p, jp, **TOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses), **TOL)


# ------------------------------------------------------- the port's identities

@pytest.fixture(scope="module")
def start(data):
    _, (x, y, counts) = data
    eng = _engine(server_optimizer=adam(1e-3))
    params = W.init_params(3, device="cpu")
    idx = eng.draw_batch_indices(counts, 4, n_rounds=K)
    return eng, params, (x, y, counts), idx


def test_fused_equals_sequential_rounds(start):
    eng, params, (x, y, counts), idx = start
    masks = np.stack([MASK, np.ones(S, np.float32), MASK])
    p, s, losses, stats = eng.run_rounds(params, x, y, counts, None, K,
                                         mask=masks, batch_idx=idx)
    q, r = params, eng.init(params)
    for k in range(K):
        q, r, loss, st = eng.round(q, r, x, y, counts, mask=masks[k],
                                   batch_idx=idx[k])
        assert torch.equal(losses[k], loss)
        assert all(torch.equal(stats[n][k], st[n]) for n in st)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((p, s)),
                                                  tree_leaves((q, r))))
    assert int(s.count) == K
    # a continued run picks the server state up where it stopped
    p2, s2, _, _ = eng.run_rounds(p, x, y, counts, None, 1, opt_state=s,
                                  batch_idx=idx[0])
    q2, r2, _, _ = eng.round(q, r, x, y, counts, batch_idx=idx[0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((p2, s2)),
                                                  tree_leaves((q2, r2))))


def test_async_round_is_round_with_discounted_mask(start):
    eng, params, (x, y, counts), idx = start
    spec = tf.AsyncRoundSpec(quorum=2, staleness_discount=0.5)
    accept = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    stale = np.asarray([0.0, 1.0, 3.0, 2.0], np.float32)
    state = eng.init(params)
    a = eng.async_round(params, state, x, y, counts, None, accept, stale,
                        spec, batch_idx=idx[0])
    b = eng.round(params, state, x, y, counts,
                  mask=accept * 0.5**stale, batch_idx=idx[0])
    assert all(torch.equal(u, v) for u, v in zip(tree_leaves(a),
                                                  tree_leaves(b)))
    # one fused async round from the same staleness is the same round
    p, _, new_stale, losses, _ = eng.run_rounds_async(
        params, x, y, counts, None, 1, accept, spec, staleness=stale,
        batch_idx=idx[0])
    assert all(torch.equal(u, v) for u, v in zip(tree_leaves(p),
                                                  tree_leaves(a[0])))
    assert torch.equal(losses[0], a[2])
    assert new_stale.tolist() == [0.0, 2.0, 0.0, 0.0]


def test_batched_stations_equal_the_loop(start):
    """The round (stations under vmap) == the same round with the stations
    walked one by one: params + the masked mean of the loop's deltas."""
    _, params, (x, y, counts), idx = start
    eng = _engine()
    a = eng.round(params, eng.init(params), x, y, counts, mask=MASK,
                  batch_idx=idx[0])
    with torch.no_grad():
        deltas, losses = eng.mesh.fed_map(
            eng._local_update, x, y, idx[0], replicated_args=(params,),
            batched=False)
    weights = counts * torch.from_numpy(MASK)
    loop = tree_map(torch.add, params, fed_mean(deltas, weights=weights))
    _close(a[0], jax.tree.map(np.asarray, W.params_to_numpy(loop)), **TOL)
    np.testing.assert_allclose(float(a[2]),
                               float(fed_mean(losses, weights=weights)), **TOL)


def test_round_moves_its_inputs_to_the_engine(start):
    """Params and server state given as numpy arrays and Python numbers are
    placed on the engine's device: the same round as with its tensors."""
    _, params, (x, y, counts), idx = start
    eng = _engine(server_optimizer=adam(1e-3))
    state = eng.init(params)
    a = eng.round(params, state, x, y, counts, batch_idx=idx[0])
    b = eng.round(W.params_to_numpy(params),
                  tree_map(lambda v: v.numpy() if v.dim() else int(v), state),
                  x.numpy(), y.numpy(), counts.numpy(), batch_idx=idx[0])
    assert all(torch.equal(u, v) for u, v in zip(tree_leaves(a),
                                                  tree_leaves(b)))
    p, _, losses, _ = eng.run_rounds(W.params_to_numpy(params), x, y, counts,
                                     None, 1, batch_idx=idx[0])
    assert all(torch.equal(u, v) for u, v in zip(tree_leaves(p),
                                                  tree_leaves(a[0])))
    assert torch.equal(losses[0], a[2])


def test_learning_stats_off_returns_empty(start):
    _, params, (x, y, counts), idx = start
    eng = _engine(learning_stats=False)
    assert eng.round(params, eng.init(params), x, y, counts,
                     batch_idx=idx[0])[3] == {}
    out = eng.run_rounds(params, x, y, counts, None, K, batch_idx=idx)
    assert out[3] == {} and out[2].shape == (K,)


def test_drawn_batch_indices(data):
    _, (x, y, counts) = data
    eng = _engine()
    idx = eng.draw_batch_indices(counts, 0, n_rounds=5)
    assert idx.shape == (5, S, L, B) and idx.dtype == torch.int64
    bound = torch.clamp_min(counts.long(), 1).reshape(1, S, 1, 1)
    assert bool((idx >= 0).all()) and bool((idx < bound).all())
    assert bool((idx[:, 0] == 0).all())  # the empty station: row 0 only
    assert torch.equal(idx, eng.draw_batch_indices(counts, 0, n_rounds=5))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(idx, eng.draw_batch_indices(counts, gen, n_rounds=5))
    # a key draws the same as the indices it would have drawn
    params = W.init_params(0, device="cpu")
    state = eng.init(params)
    a = eng.round(params, state, x, y, counts, key=0)
    b = eng.round(params, state, x, y, counts, batch_idx=idx[0])
    assert torch.equal(a[2], b[2])


def test_contracts():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        W.make_engine(n_stations=S, device="cpu", compressor=object())
    eng = _engine()
    assert eng.compression_stats(W.init_params(0, device="cpu")) is None
    x = torch.zeros(S, 5, 28, 28, 1)
    y = torch.zeros(S, 5, dtype=torch.int32)
    counts = torch.full((S,), 5.0)
    params = W.init_params(0, device="cpu")
    with pytest.raises(ValueError, match="pass a key or batch_idx"):
        eng.round(params, eng.init(params), x, y, counts)
    with pytest.raises(ValueError, match="n_rounds must be >= 1"):
        eng.run_rounds(params, x, y, counts, 0, 0)
    with pytest.raises(ValueError, match="batch_idx must be"):
        eng.round(params, eng.init(params), x, y, counts,
                  batch_idx=np.zeros((S, L + 1, B), np.int64))
    for bad in (dict(quorum=0), dict(quorum=1, over_select=-1),
                dict(quorum=1, staleness_discount=0.0),
                dict(quorum=1, deadline_s=0.0)):
        with pytest.raises(ValueError):
            tf.AsyncRoundSpec(**bad).validate()
        with pytest.raises(ValueError):
            jf.AsyncRoundSpec(**bad).validate()
    spec = tf.AsyncRoundSpec(quorum=3, over_select=2, staleness_discount=0.3)
    assert spec.n_select == 5
    stale = np.asarray([0.0, 1.0, 4.0], np.float32)
    np.testing.assert_allclose(
        spec.staleness_weights(stale).numpy(),
        np.asarray(jf.AsyncRoundSpec(quorum=3, staleness_discount=0.3)
                   .staleness_weights(stale)), rtol=1e-6)
    assert W.make_engine(n_stations=S, device="cpu").server_opt == sgd(1.0)


def test_train_fedavg_and_evaluate(jax_params):
    params, losses = W.train_fedavg(FederationMesh(S, device="cpu"),
                                    n_rounds=2, local_steps=2, batch_size=8)
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    ex, ey = synthetic_image_classes(64, seed=777, noise=2.0)
    ours = W.evaluate(W.params_from_jax(jax_params, "cpu"), ex, ey)
    theirs = JW.evaluate(jax_params, ex, ey)
    # bf16 logits on both sides: an argmax may flip on a near tie
    assert abs(ours - theirs) <= 2 / 64
