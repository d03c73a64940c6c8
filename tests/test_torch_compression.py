"""The port's gradient compression against the JAX package's, on the CPU.

The same numpy vectors go through both packages. JAX draws the int8
rounding noise with ``jax.random.uniform(key, (c, chunk))``; the tests
recompute those uniforms and inject them into the port as ``noise``, so the
two quantize with the same draws and must agree bit for bit: the port
repeats the JAX ops in the same f32 order (max, divide, add, floor, clip),
and top-k breaks ties by index on both sides. The JAX functions run
eagerly here, as written: under ``jit`` XLA turns ``max / 127`` into a
multiply by the reciprocal, which moves a scale by one ulp, so the engine
cases (jitted on the JAX side) are held to a tolerance instead. Where the port draws its own
noise (the statistical cases) it is held to the property, not to JAX.

The engine cases run the JAX package's ``tiny_fed`` linear federation
(8 stations, 12 features, 2 local steps of 16) through both engines with
the JAX draws injected: batch indices (``fold_in(round_key, station)`` ->
``split`` -> ``randint``) and noise (``split(fold_in(round_key, 2**31 -
1), S)`` -> ``uniform``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vantage6_tpu_torch._tree import tree_leaves
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed import compression as C
from vantage6_tpu_torch.fed import fedavg as tf
from vantage6_tpu_torch.fed.compression import CompressorSpec
from vantage6_tpu_torch.optim import adam

JC = importlib.import_module("vantage6_tpu.fed.compression")
jf = importlib.import_module("vantage6_tpu.fed.fedavg")
JaxMesh = importlib.import_module("vantage6_tpu.core.mesh").FederationMesh


def _vec(seed, n=512):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def _jspec(spec):
    return JC.CompressorSpec(**{f: getattr(spec, f) for f in (
        "topk_ratio", "int8", "chunk", "error_feedback")})


def _u(key, n, chunk):
    """The uniforms ``quantize_int8`` draws with ``key``, flat."""
    c = -(-n // chunk)
    return np.array(jax.random.uniform(key, (c, chunk))).reshape(-1)


def _eq(ours, theirs):
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))


# ---------------------------------------------------------------- spec math
class TestCompressorSpec:
    def test_validation(self):
        for mod in (C, JC):
            mod.CompressorSpec(topk_ratio=0.5, int8=True).validate()
            with pytest.raises(ValueError, match="topk_ratio"):
                mod.CompressorSpec(topk_ratio=0.0).validate()
            with pytest.raises(ValueError, match="topk_ratio"):
                mod.CompressorSpec(topk_ratio=1.5).validate()
            with pytest.raises(ValueError, match="chunk"):
                mod.CompressorSpec(int8=True, chunk=0).validate()

    def test_identity_flag(self):
        assert CompressorSpec().identity
        assert not CompressorSpec(int8=True).identity
        assert not CompressorSpec(topk_ratio=0.1).identity

    @pytest.mark.parametrize("n", [7, 10, 4096, 100_000, 421_642])
    def test_wire_nbytes_ratio_and_k_match_jax(self, n):
        for kw in ({}, {"int8": True}, {"topk_ratio": 0.1},
                   {"topk_ratio": 0.1, "int8": True},
                   {"topk_ratio": 0.001, "int8": True, "chunk": 64},
                   {"topk_ratio": 1.0}):
            ours, theirs = CompressorSpec(**kw), JC.CompressorSpec(**kw)
            assert ours.k_for(n) == theirs.k_for(n)
            assert ours.wire_nbytes(n) == theirs.wire_nbytes(n)
            assert ours.ratio(n) == theirs.ratio(n)
        s = CompressorSpec(topk_ratio=0.1, int8=True, chunk=256)
        if n >= 4096:
            assert s.wire_nbytes(n) == 5 * s.k_for(n) + 4 * (-(-n // 256))
            assert s.ratio(n) > 4.0  # the bench's acceptance bar

    def test_k_for_bounds(self):
        assert CompressorSpec(topk_ratio=0.001).k_for(10) == 1
        assert CompressorSpec(topk_ratio=1.0).k_for(7) == 7


# ------------------------------------------------------------ int8 numerics
class TestStochasticInt8:
    @pytest.mark.parametrize("n,chunk", [(256, 64), (1000, 256), (100, 32),
                                         (5, 16)])
    def test_quantize_matches_jax_with_its_draws(self, n, chunk):
        x = _vec(n, n) * 3.0
        key = jax.random.key(n)
        jq, js = JC.quantize_int8(jnp.asarray(x), key, chunk)
        q, s = C.quantize_int8(torch.from_numpy(x), None, chunk,
                               noise=torch.from_numpy(_u(key, n, chunk)))
        assert q.dtype == torch.int8 and q.shape == (n,)
        _eq(q, jq)
        _eq(s, js)
        _eq(C.dequantize_int8(q, s, chunk), JC.dequantize_int8(jq, js, chunk))

    def test_int8_roundtrip_is_unbiased(self):
        """Over 400 seeded draws of the port's own noise the mean
        round-trip error vanishes while one draw is visibly lossy."""
        x = torch.from_numpy(_vec(1, 256))
        gen = torch.Generator().manual_seed(0)
        draws = torch.stack([C.dequantize_int8(*C.quantize_int8(x, gen, 64),
                                               64) for _ in range(400)])
        single = (draws[0] - x).abs().mean()
        mean_err = (draws.mean(0) - x).abs().mean()
        assert single > 0
        # the bias shrinks ~1/sqrt(draws); 10x is a loose, stable bound
        assert mean_err < single / 10

    def test_deterministic_per_seed(self):
        x = torch.from_numpy(_vec(2, 100))
        a = C.quantize_int8(x, 7, 32)
        b = C.quantize_int8(x, torch.Generator().manual_seed(7), 32)
        assert all(torch.equal(u, v) for u, v in zip(a, b))

    def test_zero_chunk_quantizes_to_zero(self):
        q, s = C.quantize_int8(torch.zeros(64), 0, 16)
        assert bool((q == 0).all()) and bool((s == 0).all())
        assert torch.equal(C.dequantize_int8(q, s, 16), torch.zeros(64))

    def test_per_chunk_scale_isolates_outliers(self):
        x = np.full(128, 0.01, np.float32)
        x[3] = 1e4
        key = jax.random.key(1)
        u = torch.from_numpy(_u(key, 128, 64))
        q, s = C.quantize_int8(torch.from_numpy(x), None, 64, noise=u)
        out = C.dequantize_int8(q, s, 64).numpy()
        assert np.abs(out[64:] - 0.01).max() < 0.01 / 64
        assert abs(out[3] - 1e4) < 1e4 / 100
        _eq(out, JC.dequantize_int8(*JC.quantize_int8(jnp.asarray(x), key,
                                                      64), 64))

    def test_codes_stay_in_int8_range(self):
        q, _ = C.quantize_int8(torch.from_numpy(_vec(3, 1000) * 1e6), 2, 256)
        assert q.dtype == torch.int8
        assert int(q.min()) >= -127 and int(q.max()) <= 127


# ----------------------------------------------------- top-k error feedback
def _both(spec, x, ef=None, seed=0, cast=None):
    """compress_with_feedback in both packages on the same vector and
    draws: ((payload, hat, new_ef) ours, theirs)."""
    n = x.shape[-1]
    key = jax.random.key(seed)
    noise = (torch.from_numpy(_u(key, n, spec.chunk)) if spec.int8
             else None)
    ef = np.zeros(n, np.float32) if ef is None else ef
    ours = C.compress_with_feedback(
        spec, torch.from_numpy(x), torch.from_numpy(ef), None,
        cast_dtype=None if cast is None else getattr(torch, cast),
        noise=noise)
    theirs = JC.compress_with_feedback(
        _jspec(spec), jnp.asarray(x), jnp.asarray(ef), key,
        cast_dtype=None if cast is None else getattr(jnp, cast))
    for name in theirs[0]:
        _eq(ours[0][name], theirs[0][name])
    assert sorted(ours[0]) == sorted(theirs[0])
    _eq(ours[1], theirs[1])
    _eq(ours[2], theirs[2])
    return ours


class TestTopKErrorFeedback:
    def test_dropped_mass_reappears_exactly(self):
        spec = CompressorSpec(topk_ratio=0.25)
        x = _vec(4, 64)
        payload, hat, new_ef = _both(spec, x)
        idx = payload["indices"].long()
        assert payload["indices"].dtype == torch.int32
        assert torch.equal(idx, torch.sort(idx).values)
        assert torch.equal(new_ef, torch.from_numpy(x) - hat)
        assert bool((new_ef[idx] == 0).all())
        dropped = np.setdiff1d(np.arange(64), idx.numpy())
        _eq(new_ef[dropped], x[dropped])
        assert bool((hat[dropped] == 0).all())

    def test_accumulator_reinjected_next_round(self):
        """A coordinate dropped round after round accumulates its mass
        exactly and ships the whole total once it makes the cut. Round 1
        has eleven tied 3.0s for five places: the lower indices win, as in
        jax.lax.top_k."""
        spec = CompressorSpec(topk_ratio=0.1)
        n = 50
        delta = np.zeros(n, np.float32)
        delta[20:31] = 3.0
        delta[7] = 1.0
        p1, hat1, ef = _both(spec, delta, seed=1)
        assert p1["indices"].tolist() == [20, 21, 22, 23, 24]
        assert float(hat1[7]) == 0.0 and float(ef[7]) == 1.0
        delta2 = np.zeros(n, np.float32)
        delta2[7] = 1.0
        _, hat2, ef2 = _both(spec, delta2, ef.numpy(), seed=2)
        assert float(hat2[7]) == 0.0 and float(ef2[7]) == 2.0
        delta3 = np.zeros(n, np.float32)
        delta3[7] = 2.0
        _, hat3, ef3 = _both(spec, delta3, ef2.numpy(), seed=3)
        assert float(hat3[7]) == 4.0 and float(ef3[7]) == 0.0

    def test_ef_exact_with_int8_composed(self):
        spec = CompressorSpec(topk_ratio=0.2, int8=True, chunk=32)
        x = _vec(5, 200)
        _, hat, new_ef = _both(spec, x, ef=_vec(6, 200) * 0.1, seed=3)
        assert torch.equal(new_ef, (torch.from_numpy(x)
                                    + torch.from_numpy(_vec(6, 200) * 0.1))
                           - hat)

    def test_error_feedback_off_keeps_zero_state(self):
        spec = CompressorSpec(topk_ratio=0.2, error_feedback=False)
        _, _, new_ef = _both(spec, _vec(7, 100), ef=_vec(8, 100), seed=4)
        assert bool((new_ef == 0).all())

    def test_comm_dtype_cast_error_lands_in_ef(self):
        spec = CompressorSpec(topk_ratio=1.0)
        x = _vec(9, 64) * np.float32(1.000123)
        _, hat, new_ef = _both(spec, x, seed=5, cast="bfloat16")
        casted = torch.from_numpy(x).to(torch.bfloat16).float()
        assert torch.equal(hat, casted)
        assert torch.equal(new_ef, torch.from_numpy(x) - casted)
        assert float(new_ef.abs().max()) > 0

    @pytest.mark.parametrize("kw", [
        dict(int8=True), dict(topk_ratio=0.3),
        dict(topk_ratio=0.3, int8=True, chunk=16), dict(int8=True, chunk=7),
    ])
    def test_decompress_matches_hat_bitwise(self, kw):
        spec = CompressorSpec(**kw)
        payload, hat, _ = _both(spec, _vec(10, 300), seed=6)
        assert torch.equal(C.decompress_flat(spec, payload, 300), hat)

    def test_ef_norm_matches_jax(self):
        x = _vec(11, 300)
        np.testing.assert_allclose(float(C.ef_norm(torch.from_numpy(x))),
                                   float(JC.ef_norm(jnp.asarray(x))),
                                   rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(topk_ratio=0.1, int8=True), dict(topk_ratio=0.25),
    dict(int8=True, chunk=16), dict(topk_ratio=1.0),
])
def test_compress_stacked_matches_jax(kw):
    """Batched over stations: each row its own noise, scales, survivors and
    accumulator, equal to the JAX package's vmap, bit for bit."""
    s, n = 5, 333
    spec = CompressorSpec(chunk=kw.pop("chunk", 32), **kw)
    rng = np.random.default_rng(12)
    flat = rng.normal(size=(s, n)).astype(np.float32)
    flat[1, :40] = 0.0  # ties at zero
    ef = 0.1 * rng.normal(size=(s, n)).astype(np.float32)
    keys = jax.random.split(jax.random.key(3), s)
    noise = np.stack([_u(k, n, spec.chunk) for k in keys])
    jp, jhat, jef = JC.compress_stacked(_jspec(spec), jnp.asarray(flat),
                                        jnp.asarray(ef), keys)
    payload, hat, new_ef = C.compress_stacked(
        spec, torch.from_numpy(flat), torch.from_numpy(ef), None,
        noise=torch.from_numpy(noise) if spec.int8 else None)
    for name in jp:
        _eq(payload[name], jp[name])
    _eq(hat, jhat)
    _eq(new_ef, jef)
    assert torch.equal(new_ef, (torch.from_numpy(flat)
                                + torch.from_numpy(ef)) - hat)
    assert torch.equal(C.decompress_flat(spec, payload, n), hat)


# ------------------------------------------------------------ FedAvg engine
S, DIM, L, B, LR = 8, 12, 2, 16, 0.05
# f32 on both sides: a linear model after up to 4 rounds of 2 local steps;
# the deltas agree to f32 rounding, so the same coordinates survive top-k
# and the same int8 codes come out (the cases below hold with margin)
TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_fed():
    """The JAX package's tiny_fed: 8 stations of linear regression."""
    rng = np.random.default_rng(3)
    w_true = rng.normal(size=(DIM,)).astype(np.float32)
    xs = rng.normal(size=(S, 40, DIM)).astype(np.float32)
    ys = xs @ w_true + 0.01 * rng.normal(size=(S, 40)).astype(np.float32)
    counts = np.full((S,), 40.0, np.float32)

    def j_loss(params, bx, by, w):
        pred = bx @ params["w"] + params["b"]
        return jnp.sum(w * (pred - by) ** 2) / jnp.maximum(jnp.sum(w), 1.0)

    def t_loss(params, bx, by, w):
        pred = bx @ params["w"] + params["b"]
        return torch.sum(w * (pred - by) ** 2) / torch.clamp_min(
            torch.sum(w), 1.0)

    def engines(**kw):
        jkw = {k: (getattr(jnp, v) if k == "comm_dtype" else v)
               for k, v in kw.items() if k != "server"}
        tkw = {k: (getattr(torch, v) if k == "comm_dtype" else v)
               for k, v in kw.items() if k != "server"}
        if "compressor" in kw:
            jkw["compressor"] = _jspec(kw["compressor"])
        if kw.get("server") == "adam":
            jkw["server_optimizer"] = optax.adam(1e-2)
            tkw["server_optimizer"] = adam(1e-2)
        jeng = jf.FedAvg(JaxMesh(S, devices=jax.devices()[:1]), jf.FedAvgSpec(
            loss_fn=j_loss, local_steps=L, batch_size=B, local_lr=LR,
            local_unroll=True, **jkw))
        teng = tf.FedAvg(FederationMesh(S, device="cpu"), tf.FedAvgSpec(
            loss_fn=t_loss, local_steps=L, batch_size=B, local_lr=LR, **tkw))
        return jeng, teng

    return dict(x=xs, y=ys, counts=counts, engines=engines,
                p0={"w": np.zeros(DIM, np.float32),
                    "b": np.zeros((), np.float32)})


def _idx(round_key):
    """The JAX engine's batch indices for one round: [S, L, B]."""
    return np.asarray([[np.asarray(jax.random.randint(k, (B,), 0, 40))
                        for k in jax.random.split(
                            jax.random.fold_in(round_key, sid), L)]
                       for sid in range(S)])


def _noise(round_key, spec):
    """The JAX engine's rounding uniforms for one round: [S, n_pad]."""
    keys = jax.random.split(jax.random.fold_in(round_key, 2**31 - 1), S)
    return np.stack([_u(k, DIM + 1, spec.chunk) for k in keys])


def _close(ours, theirs, **tol):
    ours, theirs = tree_leaves(ours), jax.tree.leaves(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


ENGINE_CASES = {
    "topk_int8": dict(compressor=CompressorSpec(topk_ratio=0.25, int8=True,
                                                chunk=8)),
    "int8_bf16_cast": dict(compressor=CompressorSpec(int8=True, chunk=4),
                           comm_dtype="bfloat16"),
    "scattered_adam_bf16": dict(
        compressor=CompressorSpec(topk_ratio=0.5, int8=True, chunk=8),
        shard_server_update=True, comm_dtype="bfloat16", server="adam"),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_rounds_match_jax_engine(tiny_fed, name):
    """Three rounds, station 3 masked out of round 2: params, server state,
    EF rows and stats held to the JAX engine; the masked station's EF row
    waits on both sides."""
    kw = ENGINE_CASES[name]
    spec = kw["compressor"]
    jeng, eng = tiny_fed["engines"](**kw)
    f = tiny_fed
    jp, js = jax.tree.map(jnp.asarray, f["p0"]), jeng.init(
        jax.tree.map(jnp.asarray, f["p0"]))
    p, s = f["p0"], eng.init(f["p0"])
    assert set(s) == {"server", "ef"} and s["ef"].shape == (S, DIM + 1)
    mask = np.ones(S, np.float32)
    mask[3] = 0.0
    for r, round_key in enumerate(jax.random.split(jax.random.key(1), 3)):
        m = mask if r == 1 else np.ones(S, np.float32)
        ef_before = s["ef"].clone()
        jp, js, j_loss, j_stats = jeng.round(
            jp, js, jnp.asarray(f["x"]), jnp.asarray(f["y"]),
            jnp.asarray(f["counts"]), round_key, mask=jnp.asarray(m))
        p, s, loss, stats = eng.round(
            p, s, f["x"], f["y"], f["counts"], mask=m,
            batch_idx=_idx(round_key),
            noise=_noise(round_key, spec) if spec.int8 else None)
        _close(p, jp, **TOL)
        _close(s, js, **TOL)
        np.testing.assert_allclose(float(loss), float(j_loss), **TOL)
        assert sorted(stats) == sorted(j_stats)
        assert "station_ef_norm" in stats
        for n in j_stats:
            np.testing.assert_allclose(stats[n].numpy(),
                                       np.asarray(j_stats[n]),
                                       rtol=1e-4, atol=1e-6)
        if r == 1:
            assert torch.equal(s["ef"][3], ef_before[3])
            assert not torch.equal(s["ef"][0], ef_before[0])
    assert float(s["ef"].abs().sum()) > 0


def test_run_rounds_matches_jax_engine(tiny_fed):
    """Three fused rounds with per-round rosters: the EF carry across rounds
    matches the JAX engine's scan."""
    spec = CompressorSpec(topk_ratio=0.25, chunk=8)
    jeng, eng = tiny_fed["engines"](compressor=spec)
    f, k = tiny_fed, 3
    masks = np.ones((k, S), np.float32)
    masks[1, 3] = masks[2, 5] = 0.0
    key = jax.random.key(0)
    jp, js, jl, _ = jeng.run_rounds(
        jax.tree.map(jnp.asarray, f["p0"]), jnp.asarray(f["x"]),
        jnp.asarray(f["y"]), jnp.asarray(f["counts"]), key, k,
        mask=jnp.asarray(masks), donate=False)
    keys = jax.random.split(key, k)
    p, s, losses, stats = eng.run_rounds(
        f["p0"], f["x"], f["y"], f["counts"], None, k, mask=masks,
        batch_idx=np.stack([_idx(rk) for rk in keys]),
    )
    _close(p, jp, **TOL)
    _close(s, js, **TOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), **TOL)
    assert stats["station_ef_norm"].shape == (k, S)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("spec", [CompressorSpec(),
                                  CompressorSpec(topk_ratio=1.0)],
                         ids=["identity", "topk1"])
def test_lossless_compressor_is_fp32_identical(tiny_fed, spec):
    """An identity spec, and topk_ratio=1.0 without int8, drop and round
    nothing: params, losses and stats equal the dense engine's bit for
    bit, and the accumulators stay zero."""
    f = tiny_fed
    _, dense = f["engines"]()
    _, lossless = f["engines"](compressor=spec)
    idx = np.stack([_idx(rk) for rk in jax.random.split(jax.random.key(0),
                                                        4)])
    a = dense.run_rounds(f["p0"], f["x"], f["y"], f["counts"], None, 4,
                         batch_idx=idx)
    b = lossless.run_rounds(f["p0"], f["x"], f["y"], f["counts"], None, 4,
                            batch_idx=idx)
    assert all(torch.equal(u, v) for u, v in zip(tree_leaves(a[0]),
                                                  tree_leaves(b[0])))
    assert torch.equal(a[2], b[2])
    for n in a[3]:
        assert torch.equal(a[3][n], b[3][n])
    if spec.identity:
        assert lossless.compression_stats(f["p0"]) is None
    else:
        assert bool((b[1]["ef"] == 0).all())


def test_round_and_run_rounds_share_state(tiny_fed):
    """round() and run_rounds() carry the same {"server", "ef"} state, and
    K fused rounds equal K eager rounds from generators of one seed: each
    round draws its indices, then its noise."""
    spec = CompressorSpec(topk_ratio=0.5, int8=True, chunk=4)
    f = tiny_fed
    _, eng = f["engines"](compressor=spec, server="adam")
    s0 = eng.init(f["p0"])
    p1, s1, _, _ = eng.round(f["p0"], s0, f["x"], f["y"], f["counts"], key=1)
    p2, s2, l2, _ = eng.run_rounds(p1, f["x"], f["y"], f["counts"], 2, 3,
                                   opt_state=s1)
    q, r, ls = p1, s1, []
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):
        q, r, loss, _ = eng.round(q, r, f["x"], f["y"], f["counts"], key=gen)
        ls.append(loss)
    assert all(torch.equal(u, v) for u, v in zip(tree_leaves((p2, s2)),
                                                  tree_leaves((q, r))))
    assert torch.equal(l2, torch.stack(ls))
    assert s2["ef"].shape == (S, DIM + 1) and int(s2["server"].count) == 4
    # the draws are what draw_batch_indices and the noise draw give
    gen = torch.Generator().manual_seed(5)
    idx = eng.draw_batch_indices(f["counts"], gen)
    u = C.draw_noise(gen, (S, C.noise_size(spec, DIM + 1)), eng.device)
    a = eng.round(p1, s1, f["x"], f["y"], f["counts"], key=5)
    b = eng.round(p1, s1, f["x"], f["y"], f["counts"], batch_idx=idx[0],
                  noise=u)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def test_fused_run_draws_each_round_just_before_it(tiny_fed, monkeypatch):
    """A fused run draws a round's noise just before that round, so it
    holds one round's draws at a time whatever the number of rounds."""
    spec = CompressorSpec(topk_ratio=0.5, int8=True, chunk=4)
    f = tiny_fed
    _, eng = f["engines"](compressor=spec)
    events = []
    draw, step = tf.draw_noise, eng._round_step
    monkeypatch.setattr(tf, "draw_noise", lambda *a: events.append(
        "draw") or draw(*a))
    monkeypatch.setattr(eng, "_round_step", lambda b: events.append(
        "round") or step(b))
    eng.run_rounds(f["p0"], f["x"], f["y"], f["counts"], 0, 3)
    assert events == ["draw", "round"] * 3


def test_compression_stats_and_contracts(tiny_fed):
    f = tiny_fed
    spec = CompressorSpec(topk_ratio=0.1, int8=True)
    jeng, eng = f["engines"](compressor=spec)
    assert eng.compression_stats(f["p0"]) == jeng.compression_stats(
        jax.tree.map(jnp.asarray, f["p0"]))
    with pytest.raises(ValueError, match="pass a key or noise"):
        eng.round(f["p0"], eng.init(f["p0"]), f["x"], f["y"], f["counts"],
                  batch_idx=_idx(jax.random.key(0)))
    with pytest.raises(ValueError, match="noise must be"):
        eng.round(f["p0"], eng.init(f["p0"]), f["x"], f["y"], f["counts"],
                  batch_idx=_idx(jax.random.key(0)),
                  noise=np.zeros((S, 3), np.float32))
    with pytest.raises(ValueError, match="topk_ratio"):
        tf.FedAvg(eng.mesh, tf.FedAvgSpec(
            loss_fn=eng.spec.loss_fn,
            compressor=CompressorSpec(topk_ratio=2.0)))
