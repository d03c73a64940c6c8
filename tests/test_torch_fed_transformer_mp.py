"""The port's federated transformer engine over ranks
(``make_engine(..., group=)``) on real gloo groups on the CPU.

Two ranks run S = 2 stations at one rank a station (``seq_devices = 1``),
on the ring and on the flash path (the kernel's plain version on the
CPU); four ranks run S = 4 stations packed two a slot at ``seq_devices =
2``, the reference's (station, seq) mesh, on the ring across ranks. Each
rank holds its ``[S_local, B, T/P]`` block, and every rank must end with
the same params.

All start from one JAX ``init_params``, train on ``make_federated_tokens``
and are held, in this process, against the one-card engine on the same
inputs, and the four-rank run also against the JAX engine at
``seq_devices=2`` on conftest's 8 fake CPU devices, at the tolerances of
``tests/test_torch_fed_transformer.py``: the loss at rtol 1e-5, Adam's
params at lr / 1000, and under ``sgd(1.0)`` a round's move, minus the
aggregated gradient, at rtol 1e-4 and atol 1e-8: P times the gradient of
the round's loss, the reference's factor. At this width (d_model 64,
where that file runs 16) gradients reach 0.11, where atol 1e-8 is about
one f32 ulp, so two rules on the reference gradient meet the elements
that rounding decides: ``adam_unsettled`` leaves out of the JAX
comparison of Adam's params the few whose step rounding picks, and
``move_tolerance`` holds the move against autograd's gradient to no less
than the leaf's rounding floor.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_distributed import run_ranks
from vantage6_tpu_torch._tree import tree_leaves, tree_unflatten
from vantage6_tpu_torch.optim import sgd
from vantage6_tpu_torch.workloads import fed_transformer as TT

JT = importlib.import_module("vantage6_tpu.workloads.fed_transformer")

LR = 3e-3
KW = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, max_len=64)
SEQ, BATCH = 64, 2
MASKS = {2: [1.0, 1.0], 4: [1.0, 1.0, 1.0, 0.0]}
ROUNDS = 2  # Adam rounds; one sgd(1.0) round beside them
ADAM_EPS = 1e-8  # optax.adam's, and the port's Adam's


def _floor(g):
    """What summing a leaf's terms in another order can move one of its
    gradient's elements by: 8 f32 ulps of the leaf's largest element (two
    f32 runs of one gradient were 2.6 and 5.8 such ulps apart), far inside
    the (n - 1) u sum |terms| bound of a sum over the batch's tokens."""
    return 8 * np.spacing(np.abs(g).max())


def adam_unsettled(g):
    """The elements of a leaf whose Adam step the f32 rounding of their
    gradient ``g`` decides: the first step is lr * g / (|g| + eps), and
    where a change of ``_floor(g)`` in g moves it by more than lr / 1000
    the sum's last digits pick the step. The JAX comparison leaves these
    out (at this width 172 of 106,496 elements; of them three were 3.5e-6
    to 8.8e-6 off, |g| 1.9e-9 to 1.1e-7 against leaf maxima near 3e-2)."""
    return _floor(g) * ADAM_EPS / (np.abs(g) + ADAM_EPS) ** 2 > 1e-3


def move_tolerance(g):
    """The sibling file's tolerance for a move against the gradient
    ``g``, 1e-8 + 1e-4 |g|, but never below ``_floor(g)``, 1.5e-8 to 6.0e-8
    in the leaves whose largest element passes 1/32 (at this width 14,900
    of 106,496 elements take the floor; one of them, |g| 3.6e-5 in a leaf
    whose largest is 0.11, was 1.9e-8 off, another 2.1e-8)."""
    return np.maximum(1e-8 + 1e-4 * np.abs(g), _floor(g))


_BODY = """
import dataclasses
from vantage6_tpu_torch.optim import sgd
from vantage6_tpu_torch.workloads import fed_transformer as TT

setup = torch.load(f"{sys.argv[4]}/setup.pt", weights_only=False)
n_stations, seq_devices = setup["layout"]
for attention in setup["attentions"]:
    cfg = TT.TransformerConfig(**setup["kw"], attention=attention)
    for opt_name, rounds in (("adam", setup["rounds"]), ("sgd", 1)):
        eng = TT.make_engine(n_stations, seq_devices, cfg, lr=setup["lr"],
                             device="cpu",
                             group=torch.distributed.group.WORLD)
        if opt_name == "sgd":
            eng = dataclasses.replace(eng, optimizer=sgd(1.0))
        params = TT.params_from_jax(setup["params"], "cpu")
        opt = eng.optimizer.init(params)
        tokens = eng.shard_tokens(setup["tokens"])
        losses = []
        for _ in range(rounds):
            params, opt, loss = eng.round(params, opt, tokens,
                                          torch.tensor(setup["mask"]))
            losses.append(float(loss))
        res[(attention, opt_name)] = (params, losses)
        res["block"] = (list(eng.mesh.local_stations), tuple(tokens.shape))
"""


def _setup(n_stations, seq_devices, attentions):
    jcfg = JT.TransformerConfig(**KW, attention="ring")
    params = jax.device_get(JT.init_params(jax.random.key(0), jcfg))
    return dict(
        layout=(n_stations, seq_devices), attentions=attentions, kw=KW,
        lr=LR, rounds=ROUNDS, mask=MASKS[n_stations],
        params=jax.tree.map(np.asarray, params),
        tokens=JT.make_federated_tokens(n_stations, BATCH, SEQ, KW["vocab"]))


def _ranks(tmp_path_factory, n, setup):
    d = tmp_path_factory.mktemp(f"ranks{n}")
    torch.save(setup, d / "setup.pt")
    return setup, run_ranks(d, _BODY, n=n)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _ranks(tmp_path_factory, 2, _setup(2, 1, ["ring", "flash"]))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _ranks(tmp_path_factory, 4, _setup(4, 2, ["ring"]))


def _one_card(setup, attention, opt_name):
    n_stations, seq_devices = setup["layout"]
    cfg = TT.TransformerConfig(**KW, attention=attention)
    eng = TT.make_engine(n_stations, seq_devices, cfg, lr=LR, device="cpu")
    if opt_name == "sgd":
        eng = dataclasses.replace(eng, optimizer=sgd(1.0))
    params = TT.params_from_jax(setup["params"], "cpu")
    opt = eng.optimizer.init(params)
    tokens = eng.shard_tokens(setup["tokens"])
    losses = []
    for _ in range(ROUNDS if opt_name == "adam" else 1):
        params, opt, loss = eng.round(params, opt, tokens,
                                      torch.tensor(setup["mask"]))
        losses.append(float(loss))
    return params, losses


def _jax(setup, opt_name):
    n_stations, seq_devices = setup["layout"]
    jcfg = JT.TransformerConfig(**KW, attention="ring")
    eng = JT.make_engine(n_stations=n_stations, seq_devices=seq_devices,
                         cfg=jcfg, lr=LR)
    if opt_name == "sgd":
        eng = dataclasses.replace(eng, optimizer=optax.sgd(1.0))
    params = jax.tree.map(jnp.asarray, setup["params"])
    opt = eng.optimizer.init(params)
    tokens = eng.shard_tokens(setup["tokens"])
    losses = []
    for _ in range(ROUNDS if opt_name == "adam" else 1):
        params, opt, loss = eng.round(params, opt, tokens,
                                      jnp.asarray(setup["mask"]))
        losses.append(float(loss))
    return jax.tree.map(np.asarray, jax.device_get(params)), losses


def _hold(ranks, ref_params, ref_losses, setup, opt_name, grads=None):
    """Each rank's losses and params against the reference's at the
    sibling file's tolerances; with ``grads`` (the reference's gradient,
    leaf by leaf) Adam's params leave out ``adam_unsettled``."""
    p0 = tree_leaves(TT.params_from_jax(setup["params"], "cpu"))
    for params, losses in ranks:
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=1e-5)
        for i, (a0, a, b) in enumerate(zip(p0, tree_leaves(params),
                                           ref_params, strict=True)):
            keep = (np.ones(b.shape, bool) if grads is None
                    or opt_name != "adam" else ~adam_unsettled(grads[i]))
            if opt_name == "adam":
                np.testing.assert_allclose(a.numpy()[keep], b[keep], rtol=0,
                                           atol=LR / 1000)
            else:  # the round's move: minus the aggregated gradient
                np.testing.assert_allclose((a0 - a).numpy()[keep],
                                           (a0.numpy() - b)[keep],
                                           rtol=1e-4, atol=1e-8)
    # every rank holds the same model
    for other in ranks[1:]:
        for a, b in zip(tree_leaves(ranks[0][0]), tree_leaves(other[0])):
            assert torch.equal(a, b)


def test_each_rank_holds_its_block(two, four):
    assert [r["block"] for r in two[1]] == [([0], (1, BATCH, SEQ)),
                                           ([1], (1, BATCH, SEQ))]
    # four ranks: slots of two ranks, two stations a slot, half a sequence
    half = (2, BATCH, SEQ // 2)
    assert [r["block"] for r in four[1]] == [([0, 1], half)] * 2 + [
        ([2, 3], half)] * 2


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
@pytest.mark.parametrize("attention", ["ring", "flash"])
def test_two_ranks_match_the_one_card_engine(two, attention, opt_name):
    setup, ranks = two
    params, losses = _one_card(setup, attention, opt_name)
    _hold([r[(attention, opt_name)] for r in ranks],
          [x.numpy() for x in tree_leaves(params)], losses, setup, opt_name)


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
def test_ring_over_four_ranks_matches_the_one_card_engine(four, opt_name):
    setup, ranks = four
    params, losses = _one_card(setup, "ring", opt_name)
    _hold([r[("ring", opt_name)] for r in ranks],
          [x.numpy() for x in tree_leaves(params)], losses, setup, opt_name)


def _jax_gradient(setup):
    """The JAX engine's aggregated gradient at the initial params (its
    sgd(1.0) round's move), leaf by leaf."""
    p0 = jax.tree.leaves(setup["params"])
    moved, _ = _jax(setup, "sgd")
    return [a0 - a for a0, a in zip(p0, jax.tree.leaves(moved), strict=True)]


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
def test_ring_over_four_ranks_matches_jax_seq_devices_2(four, opt_name):
    setup, ranks = four
    params, losses = _jax(setup, opt_name)
    grads = _jax_gradient(setup) if opt_name == "adam" else None
    _hold([r[("ring", opt_name)] for r in ranks], jax.tree.leaves(params),
          losses, setup, opt_name, grads=grads)


def test_the_aggregated_gradient_is_p_times_the_losss(four):
    """Under sgd(1.0) the four ranks' move is P = 2 times the gradient of
    the round's own loss (the mean of the stations' losses under the
    mask), by autograd on the whole sequences: the reference's factor."""
    setup, ranks = four
    p0 = TT.params_from_jax(setup["params"], "cpu")
    cfg = TT.TransformerConfig(**KW, attention="ring")
    leaves = [x.detach().requires_grad_() for x in tree_leaves(p0)]
    params = tree_unflatten(p0, leaves)
    tokens = torch.from_numpy(setup["tokens"]).long()
    w = torch.tensor(setup["mask"])
    loss = sum(w[s] * TT.loss_local(params, tokens[s], cfg, 2)
               for s in range(4)) / w.sum()
    grads = [2 * g.numpy() for g in torch.autograd.grad(loss, leaves)]
    moved, _ = ranks[0][("ring", "sgd")]
    for a0, a, g in zip(tree_leaves(p0), tree_leaves(moved), grads):
        err = np.abs((a0 - a).numpy() - g)
        assert (err <= move_tolerance(g)).all(), (
            err.max(), (err - move_tolerance(g)).max())


def test_a_rank_without_a_station_is_refused(monkeypatch):
    """Three stations over four ranks of two a slot: three's largest
    divisor that fits two slots is one, so ranks 2 and 3 would hold no
    station, and make_engine says so (on a mesh stand-in with that
    layout: a real one needs the group's ranks)."""
    class NoSlot:
        slot, rank, world_size, station_axis_size = None, 2, 4, 1

    monkeypatch.setattr(TT, "FederationMesh", lambda *a, **k: NoSlot())
    with pytest.raises(ValueError, match="rank 2 of 4 holds no station"):
        TT.make_engine(3, 2, TT.TransformerConfig(**KW), device="cpu",
                       group=object())
