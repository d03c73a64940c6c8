"""The port's ring attention and tensor parallelism against the JAX
package's.

The same numpy inputs (from a seed) go through both. JAX runs its ring in
``shard_map`` over conftest's 8 fake CPU devices, and its tensor-parallel
blocks under ``jax.vmap`` with a named axis (``psum`` over the shards);
the port stacks the shards on a leading axis on the CPU.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from vantage6_tpu_torch._tree import tree_leaves, tree_map_with_path
from vantage6_tpu_torch.parallel import tensor as TP

JR = importlib.import_module("vantage6_tpu.parallel.ring_attention")
JTP = importlib.import_module("vantage6_tpu.parallel.tensor")
TR = importlib.import_module("vantage6_tpu_torch.parallel.ring_attention")

FWD_TOL = 2e-5  # the JAX suite's ring-vs-reference tolerance
GRAD_TOL = 5e-4
TP_TOL = 1e-5


def _qkv(b, t, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_ring(qkv, shards, causal):
    mesh = Mesh(np.array(jax.devices()[:shards]), ("seq",))
    return JR.ring_attention_sharded(mesh, *map(jnp.asarray, qkv), "seq",
                                     causal=causal)


@pytest.mark.parametrize("shards,t", [(8, 64), (3, 24), (5, 40)],
                         ids=["P8", "P3", "P5"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(shards, t, causal):
    qkv = _qkv(2, t, 2, 16)
    ref = np.asarray(_jax_ring(qkv, shards, causal))
    ours = TR.ring_attention_sharded(*map(torch.from_numpy, qkv), shards,
                                     causal=causal)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=FWD_TOL, atol=FWD_TOL)
    oracle = TR.reference_attention(*map(torch.from_numpy, qkv),
                                    causal=causal)
    np.testing.assert_allclose(ours.numpy(), oracle.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_match_jax(causal):
    qkv = _qkv(1, 32, 2, 8, seed=1)

    def jloss(*qkv):
        return jnp.sum(jnp.sin(_jax_ring(qkv, 8, causal)))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    tq = [torch.from_numpy(x).requires_grad_() for x in qkv]
    out = TR.ring_attention_sharded(*tq, 8, causal=causal)
    tgrads = torch.autograd.grad(torch.sin(out).sum(), tq)
    for name, a, b in zip("qkv", jgrads, tgrads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_sequence_not_divisible_by_shards_raises():
    q = torch.zeros(1, 10, 2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        TR.ring_attention_sharded(q, q, q, 4)


def test_bf16_ring_is_held_to_the_f32_oracle():
    """bf16 inputs: the products accumulate in f32 and p is rounded to
    bf16 before p.v, as in the reference; the output is rounded to bf16.
    Held to the f32 oracle on the same (bf16-exact) inputs within 2 bf16
    ulps of the output's magnitude."""
    qkv = [torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(2, 64, 2, 16)]
    out = TR.ring_attention_sharded(*qkv, 4, causal=True)
    assert out.dtype == torch.bfloat16
    oracle = TR.reference_attention(*(x.float() for x in qkv), causal=True)
    tol = 2 * 2.0**-8
    err = (out.float() - oracle).abs().max().item()
    assert err <= tol + tol * oracle.abs().max().item(), err


def test_fully_masked_block_adds_nothing():
    """A block whose keys all lie ahead of the queries changes no
    accumulator: the floored max keeps exp(-1e30 - m) at exactly 0."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 4))
    m = torch.full((1, 2, 8), TR.NEG_INF)
    l = torch.zeros(1, 2, 8)
    o = torch.zeros(1, 8, 2, 4)
    m1, l1, o1 = TR._block_attention(q, k, v, m, l, o, None, 0.5)
    mask = torch.full((8, 8), TR.NEG_INF)
    m2, l2, o2 = TR._block_attention(q, k, v, m1, l1, o1, mask, 0.5)
    assert torch.equal(m2, m1) and torch.equal(l2, l1)
    assert torch.equal(o2, o1)


# ------------------------------------------------------- tensor parallelism
def _tp_inputs(shards, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w_up = (0.2 * rng.standard_normal((16, 64))).astype(np.float32)
    w_down = (0.2 * rng.standard_normal((64, 16))).astype(np.float32)
    b_up = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    up = np.stack(np.split(w_up, shards, axis=1))  # [P, 16, 64/P]
    down = np.stack(np.split(w_down, shards, axis=0))  # [P, 64/P, 16]
    b_up = np.stack(np.split(b_up, shards))  # [P, 64/P]
    return x, w_up, w_down, up, down, b_up, b


@pytest.mark.parametrize("shards", [2, 4])
def test_tp_mlp_matches_jax_and_the_dense_mlp(shards):
    x, w_up, w_down, up, down, _, _ = _tp_inputs(shards)
    ref = jax.vmap(lambda u, d: JTP.tp_mlp(jnp.asarray(x), u, d, "tp"),
                   axis_name="tp")(jnp.asarray(up), jnp.asarray(down))
    ours = TP.tp_mlp(torch.from_numpy(x), torch.from_numpy(up),
                     torch.from_numpy(down))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref)[0],
                               rtol=TP_TOL, atol=TP_TOL)
    dense = np.asarray(jax.nn.gelu(x @ w_up) @ w_down)
    np.testing.assert_allclose(ours.numpy(), dense, rtol=TP_TOL, atol=TP_TOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_column_and_row_parallel_dense_match_jax(shards):
    x, _, _, up, down, b_up, b = _tp_inputs(shards)
    jcol = jax.vmap(
        lambda w, bb: JTP.column_parallel_dense(jnp.asarray(x), w, bb)
    )(jnp.asarray(up), jnp.asarray(b_up))
    tcol = TP.column_parallel_dense(torch.from_numpy(x), torch.from_numpy(up),
                                    torch.from_numpy(b_up))
    np.testing.assert_allclose(tcol.numpy(), np.asarray(jcol), rtol=TP_TOL,
                               atol=TP_TOL)
    # the bias goes in after the reduction, once
    jrow = jax.vmap(
        lambda h, w: JTP.row_parallel_dense(h, w, "tp", jnp.asarray(b)),
        axis_name="tp",
    )(jcol, jnp.asarray(down))
    trow = TP.row_parallel_dense(tcol, torch.from_numpy(down),
                                 torch.from_numpy(b))
    np.testing.assert_allclose(trow.numpy(), np.asarray(jrow)[0],
                               rtol=TP_TOL, atol=TP_TOL)


def _nested(rng):
    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"embed": arr(8, 4),
            "layers": [{"w_up": arr(4, 16), "w_down": arr(16, 4),
                        "norm": arr(4)},
                       {"w_up": arr(4, 16), "w_down": arr(16, 4),
                        "norm": arr(4)}],
            "head": (arr(4, 8), {"w_up_extra": arr(2, 8)})}


@pytest.mark.parametrize("index", [0, 1])
def test_shard_params_for_tp_slices_the_same_leaves_as_jax(index):
    rng = np.random.default_rng(3)
    params = _nested(rng)
    rules = {"w_up": 1, "w_down": 0, "['head'][0]": 1}
    ref = JTP.shard_params_for_tp(jax.tree.map(jnp.asarray, params), index,
                                  2, rules)
    ours = TP.shard_params_for_tp(jax.tree.map(torch.from_numpy, params),
                                  index, 2, rules)
    jleaves = jax.tree.leaves(ref)
    tleaves = tree_leaves(ours)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the path strings are jax.tree_util.keystr's
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(params)[0]]
    tpaths = []
    tree_map_with_path(lambda path, x: tpaths.append(path), params)
    assert tpaths == jpaths


def test_shard_params_for_tp_not_divisible_raises():
    params = {"layers": [{"w_up": torch.zeros(4, 6)}]}
    with pytest.raises(ValueError, match="not divisible"):
        TP.shard_params_for_tp(params, 0, 4, {"w_up": 1})
