"""The benchmark's plain references against the JAX package's steps.

At a tiny size on the CPU, in float32 (skipped where JAX or flax is not
installed, as on the card's machine): the transformer reference's three
rounds (per-station gradients, their mean, Adam) against the JAX engine's
``FedTransformer.round``, and the CNN reference's three FedAvg rounds,
dense and with top-k + int8 compression and error feedback, against the
JAX ``FedAvg.round`` with the same draws (the JAX engine's batch indices
and rounding noise, recomputed from its round keys as the port's own
parity tests do).
"""
import importlib
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
jnp = jax.numpy

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

from reference import cnn as RC  # noqa: E402
from reference import transformer as RT  # noqa: E402

JT = importlib.import_module("vantage6_tpu.workloads.fed_transformer")
JF = importlib.import_module("vantage6_tpu.fed.fedavg")
JC = importlib.import_module("vantage6_tpu.fed.compression")
JM = importlib.import_module("vantage6_tpu.core.mesh")
JCNN = importlib.import_module("vantage6_tpu.models.cnn")

ROUNDS = 3
ADAM = {"lr": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8}


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)),
                        tree)


def _norms(leaves):
    return [float(np.linalg.norm(np.asarray(x, np.float64))) for x in leaves]


def test_transformer_reference_matches_jax_rounds():
    cfg = JT.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                               max_len=32, dtype=jnp.float32)
    eng = JT.make_engine(3, 1, cfg, lr=ADAM["lr"],
                         devices=jax.devices("cpu")[:1])
    params0, opt = eng.init(jax.random.key(0))
    tokens = [JT.make_federated_tokens(3, 2, 16, 64, seed=s)
              for s in range(ROUNDS)]
    params, losses, mask = params0, [], jnp.ones(3)
    for n, tok in enumerate(tokens):
        params, opt, loss = eng.round(params, opt, eng.shard_tokens(tok),
                                      mask)
        losses.append(float(loss))
        if n == 0:
            grads = [np.asarray(m) / (1 - ADAM["b1"])
                     for m in RT.leaves(opt[0].mu)]
    p0, p3 = _to_torch(params0), _to_torch(params)
    out = RT.run(p0, [torch.from_numpy(t).long() for t in tokens],
                 cfg.n_heads, ADAM)
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(out["grad_norms"], _norms(grads), rtol=1e-4)
    change = [a - b for a, b in zip(RT.leaves(p3), RT.leaves(p0))]
    np.testing.assert_allclose(out["change_norms"], _norms(change),
                               rtol=1e-4)


S, N, L, B = 4, 24, 2, 6


def _cnn_data():
    rng = np.random.default_rng(5)
    counts = np.array([24, 17, 9, 20], np.float32)
    x = rng.normal(size=(S, N, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(S, N)).astype(np.int32)
    for s in range(S):  # padded rows are zeros, as pad_shards makes them
        x[s, int(counts[s]):] = 0
        y[s, int(counts[s]):] = 0
    return x, y, counts


def _jax_idx(round_key, counts):
    return np.asarray([[np.asarray(jax.random.randint(
        k, (B,), 0, max(int(counts[sid]), 1)))
        for k in jax.random.split(jax.random.fold_in(round_key, sid), L)]
        for sid in range(S)])


def _jax_noise(round_key, n, chunk):
    keys = jax.random.split(jax.random.fold_in(round_key, 2**31 - 1), S)
    c = -(-n // chunk)
    return np.stack([np.array(jax.random.uniform(k, (c, chunk))).reshape(-1)
                     for k in keys])


@pytest.mark.parametrize("compressor", [
    None, {"topk_ratio": 0.1, "int8": True, "chunk": 256,
           "error_feedback": True}], ids=["dense", "topk-int8"])
def test_cnn_reference_matches_jax_rounds(compressor):
    model = JCNN.CNN(compute_dtype=jnp.float32)

    def loss_fn(params, bx, by, w):
        logp = jax.nn.log_softmax(model.apply({"params": params}, bx))
        nll = -jnp.take_along_axis(logp, by[:, None].astype(jnp.int32),
                                   1)[:, 0]
        return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1.0)

    spec = None if compressor is None else JC.CompressorSpec(**compressor)
    eng = JF.FedAvg(JM.FederationMesh(S, devices=jax.devices("cpu")[:1]),
                    JF.FedAvgSpec(loss_fn=loss_fn, local_steps=L,
                                  batch_size=B, local_lr=0.05,
                                  local_unroll=True, compressor=spec))
    x, y, counts = _cnn_data()
    params0 = model.init(jax.random.key(2), jnp.zeros((1, 28, 28, 1)))[
        "params"]
    params, opt = params0, eng.init(params0)
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(params0))
    steps, losses = [], []
    for round_key in jax.random.split(jax.random.key(1), ROUNDS):
        params, opt, loss, _ = eng.round(
            params, opt, jnp.asarray(x), jnp.asarray(y), jnp.asarray(counts),
            round_key)
        losses.append(float(loss))
        steps.append({"idx": torch.from_numpy(_jax_idx(round_key, counts)),
                      "noise": None if spec is None else torch.from_numpy(
                          _jax_noise(round_key, n, spec.chunk))})
        if len(steps) == 1:
            first = jax.tree.map(lambda a, b: a - b, params0, params)
    p0 = _to_torch(params0)
    out = RC.run(p0, torch.from_numpy(x), torch.from_numpy(y),
                 torch.from_numpy(counts), steps,
                 {"local_lr": 0.05, "compressor": compressor})
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(out["grad_norms"],
                               _norms(RC.leaves(first)), rtol=1e-4)
    change = RC.leaves(jax.tree.map(lambda a, b: a - b, params, params0))
    np.testing.assert_allclose(out["change_norms"], _norms(change),
                               rtol=1e-4)
