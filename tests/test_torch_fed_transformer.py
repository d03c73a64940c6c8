"""The port's federated transformer round against the JAX package's.

Both sides start from ONE JAX ``init_params`` (moved across by
``params_from_jax``) and train on identical tokens
(``make_federated_tokens``, numpy). The JAX side runs the Pallas flash
kernel in interpret mode; the port runs on the CPU, where its flash
attention is the kernel's plain version.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vantage6_tpu_torch._tree import tree_leaves
from vantage6_tpu_torch.fed.collectives import fed_mean
from vantage6_tpu_torch.optim import adam, apply_updates
from vantage6_tpu_torch.workloads import fed_transformer as TT

JT = importlib.import_module("vantage6_tpu.workloads.fed_transformer")

LR = 3e-3
MASK = [1.0, 1.0, 1.0, 0.0]


def _cfgs(n_layers=2, remat=False, dtype="float32"):
    kw = dict(vocab=32, d_model=16, n_heads=2, n_layers=n_layers, max_len=64)
    jcfg = JT.TransformerConfig(
        **kw, attention="flash", flash_interpret=True,
        dtype={"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype],
    )
    tcfg = TT.TransformerConfig(
        **kw, attention="flash", remat=remat,
        dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype],
    )
    return jcfg, tcfg


def _jax_logits(jcfg, params, tokens):
    """JAX logits [B, T, V]; the vmap names the sequence axis that
    ``forward_local`` reads its position offset from (one shard here)."""
    return np.asarray(jax.vmap(
        lambda t: JT.forward_local(params, t, jcfg), axis_name=JT.SEQ_AXIS,
    )(jnp.asarray(tokens[None]))[0], np.float32)


@pytest.mark.parametrize("dtype,tol", [
    ("float32", 2e-5),  # the JAX suite's flash-vs-ring logits tolerance
    # bf16 compute: both sides round every matmul output to bf16 in other
    # summation orders; logits are below 0.5, where a bf16 ulp is 2^-9:
    # allow 2 ulps
    ("bfloat16", 2 * 2.0**-9),
])
def test_forward_local_logits_match_jax(dtype, tol):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jparams = JT.init_params(jax.random.key(3), jcfg)
    tokens = TT.make_federated_tokens(1, batch=2, seq_len=24, vocab=32)[0]
    ref = _jax_logits(jcfg, jparams, tokens)
    ours = TT.forward_local(TT.params_from_jax(jparams, "cpu"),
                            torch.from_numpy(tokens), tcfg)
    assert ours.dtype == tcfg.dtype
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=tol, rtol=tol)


def test_make_federated_tokens_is_the_jax_copy():
    np.testing.assert_array_equal(
        TT.make_federated_tokens(4, 2, 32, 64, seed=5),
        JT.make_federated_tokens(4, 2, 32, 64, seed=5),
    )


def _two_rounds():
    """Two federated rounds on each side, station 3 masked out."""
    jcfg, tcfg = _cfgs()
    tokens = JT.make_federated_tokens(4, batch=2, seq_len=32, vocab=32)
    jeng = JT.make_engine(n_stations=4, seq_devices=1, cfg=jcfg, lr=LR)
    jparams, jopt = jeng.init(jax.random.key(0))
    teng = TT.make_engine(4, 1, tcfg, lr=LR, device="cpu")
    tparams = TT.params_from_jax(jparams, "cpu")
    topt = teng.optimizer.init(tparams)
    jtok, ttok = jeng.shard_tokens(tokens), teng.shard_tokens(tokens)
    out = []
    for _ in range(2):
        jparams, jopt, jloss = jeng.round(jparams, jopt, jtok,
                                          jnp.asarray(MASK))
        tparams, topt, tloss = teng.round(tparams, topt, ttok,
                                          torch.tensor(MASK))
        out.append(dict(
            jax=(jax.device_get(jparams), jax.device_get(jopt[0]),
                 float(jloss)),
            torch=(tparams, topt, float(tloss)),
        ))
    return out


@pytest.fixture(scope="module")
def two_rounds():
    return _two_rounds()


@pytest.mark.parametrize("r", [0, 1])
def test_round_loss_matches_jax(two_rounds, r):
    jl, tl = two_rounds[r]["jax"][2], two_rounds[r]["torch"][2]
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-6)


def test_round_aggregated_gradient_matches_jax(two_rounds):
    """After one Adam step from zero state mu = (1 - b1) * fed_mean(grads):
    the aggregated per-station gradients, compared leaf by leaf. Leaves
    peak near 1e-2; atol 1e-8 covers entries that are zero up to rounding,
    where the relative difference means nothing."""
    jmu = two_rounds[0]["jax"][1].mu
    tmu = two_rounds[0]["torch"][1].mu
    for a, b in zip(jax.tree.leaves(jmu), tree_leaves(tmu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("r", [0, 1])
def test_round_params_match_jax(two_rounds, r):
    """Adam steps each entry by ~lr * g / sqrt(v): for an entry whose
    gradient is zero up to rounding, a 1e-10 difference in g can move its
    step by a sizeable part of lr. Parameters are therefore held to
    lr / 1000 per entry: no entry's step moved by more than 0.1% of lr."""
    jp, tp = two_rounds[r]["jax"][0], two_rounds[r]["torch"][0]
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=LR / 1000)


def test_adam_matches_optax_on_identical_gradients():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": [rng.normal(size=(7,)).astype(np.float32)]}
    opt = optax.adam(1e-2)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = opt.init(jp)
    tp = jax.tree.map(torch.from_numpy, params)
    topt = adam(1e-2)
    ts = topt.init(tp)
    for step in range(4):
        grads = jax.tree.map(
            lambda x: (rng.normal(size=x.shape) * 10.0**-step).astype(
                np.float32), params,
        )
        ju, js = opt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(jax.tree.map(torch.from_numpy, grads), ts, tp)
        tp = apply_updates(tp, tu)
        assert ts.count == int(js[0].count)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)


def test_remat_matches_plain():
    tokens = TT.make_federated_tokens(2, batch=2, seq_len=16, vocab=32)
    outs = {}
    for remat in (False, True):
        _, tcfg = _cfgs(remat=remat)
        eng = TT.make_engine(2, 1, tcfg, device="cpu")
        params, opt = eng.init(torch.Generator().manual_seed(0))
        p1, _, loss = eng.round(params, opt, eng.shard_tokens(tokens),
                                torch.ones(2))
        outs[remat] = (float(loss), p1)
    assert abs(outs[False][0] - outs[True][0]) < 1e-6
    for a, b in zip(tree_leaves(outs[False][1]), tree_leaves(outs[True][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_bf16_round_trains_with_f32_master_weights():
    _, tcfg = _cfgs(n_layers=1, dtype="bfloat16")
    eng = TT.make_engine(2, 1, tcfg, lr=LR, device="cpu")
    tokens = eng.shard_tokens(
        TT.make_federated_tokens(2, batch=4, seq_len=32, vocab=32))
    params, opt = eng.init(4)
    losses = []
    for _ in range(8):
        params, opt, loss = eng.round(params, opt, tokens, torch.ones(2))
        losses.append(float(loss))
    assert all(x.dtype == torch.float32 for x in tree_leaves(params))
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0], losses


def test_nan_station_under_mask_zero_is_excluded():
    """A diverged station with weight 0 cannot poison the aggregate: the
    per-station gradients stay separate until fed_mean excludes it."""
    _, tcfg = _cfgs(n_layers=1)
    eng = TT.make_engine(2, 1, tcfg, lr=LR, device="cpu")
    tokens = eng.shard_tokens(
        TT.make_federated_tokens(2, batch=2, seq_len=16, vocab=32))
    params, _ = eng.init(1)
    _, grads = eng.station_grads(params, tokens)
    grads["pos"][1] = float("nan")
    g = fed_mean(grads, mask=torch.tensor([1.0, 0.0]))
    assert all(torch.isfinite(x).all() for x in tree_leaves(g))
    assert torch.equal(g["pos"], grads["pos"][0])


class TestMakeEngine:
    def test_flash_requires_full_sequence_per_device(self):
        _, tcfg = _cfgs()
        with pytest.raises(ValueError, match="seq_devices == 1"):
            TT.make_engine(2, 2, tcfg, device="cpu")

    def test_ring_is_not_ported_and_names_the_roadmap(self):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TT.make_engine(2, 1, TT.TransformerConfig(), device="cpu")

    def test_sequence_longer_than_max_len_rejected(self):
        _, tcfg = _cfgs()
        eng = TT.make_engine(1, 1, tcfg, device="cpu")
        with pytest.raises(ValueError, match="max_len"):
            eng.shard_tokens(np.zeros((1, 1, 65), np.int32))

    def test_no_cuda_and_no_device_raises(self, monkeypatch):
        """Without CUDA the engine never quietly runs on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _, tcfg = _cfgs()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TT.make_engine(2, 1, tcfg)
        eng = TT.make_engine(2, 1, tcfg, device="cpu")
        assert eng.device == torch.device("cpu")
        assert eng.mesh.station_axis_size == 1
        assert eng.mesh.stations_per_slot == 2
