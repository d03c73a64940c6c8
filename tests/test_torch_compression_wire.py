"""The port's compression host and wire half against the JAX package's, on
the CPU.

Frames cross between the packages: a JAX ``payload_to_wire`` frame encoded
by the JAX serialization decodes in the port, and the other way round, to
the same dense delta exactly. With the JAX draws injected as ``noise`` both
packages write byte-identical v2 frames; the JAX side runs its ops eagerly
there (``jax.disable_jit`` with its observatory off), because under
``jit`` XLA turns ``max / 127`` into a multiply by the reciprocal and
moves a scale by one ulp. The host plane's tree walk (dict insertion
order), tuple markers, bf16 leaves, every malformed-payload case of
``tests/test_compression.py`` (same exception, same message),
``spec_from_env`` and ``DeltaCompressor``'s per-instance entropy are held
to the reference, and the ``Federation`` host plane as in
``tests/test_compression.py::TestHostPlane``, with a top-k-only spec (no
random draws) giving both packages' federations the same payloads, task
after task. Vectors are a few hundred elements.
"""
import collections
import importlib
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vantage6_tpu_torch.common import serialization as TS
from vantage6_tpu_torch.fed import compression as C
from vantage6_tpu_torch.fed.compression import CompressorSpec

JC = importlib.import_module("vantage6_tpu.fed.compression")
JS = importlib.import_module("vantage6_tpu.common.serialization")
JOBS = importlib.import_module("vantage6_tpu.runtime.profiling").DEVICE_OBS

SPECS = [
    CompressorSpec(topk_ratio=0.1, int8=True, chunk=32),
    CompressorSpec(topk_ratio=0.25),
    CompressorSpec(int8=True, chunk=64),
    CompressorSpec(topk_ratio=1.0, int8=True),
]
IDS = ["topk_int8", "topk", "int8", "topk1_int8"]


def _vec(seed, n=300):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def _jspec(spec):
    return JC.CompressorSpec(**{f: getattr(spec, f) for f in (
        "topk_ratio", "int8", "chunk", "error_feedback")})


def _u(key, n, chunk):
    """The uniforms the JAX ``quantize_int8`` draws with ``key``, flat."""
    c = -(-n // chunk)
    return np.array(jax.random.uniform(key, (c, chunk))).reshape(-1)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture
def eager_jax():
    """The JAX compress ops run eagerly (observatory off, jit disabled)."""
    was = JOBS.enabled
    JOBS.configure(enabled=False)
    try:
        with jax.disable_jit():
            yield
    finally:
        JOBS.configure(enabled=was)


# ------------------------------------------------------------ frame interop
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_jax_frame_decodes_in_port_and_back(spec):
    n, x = 300, _vec(0)
    ef = 0.1 * _vec(1)
    payload, hat, _ = JC.compress_with_feedback(
        _jspec(spec), jnp.asarray(x), jnp.asarray(ef), jax.random.key(3))
    jwire = JC.payload_to_wire(_jspec(spec), payload, n)
    for fmt in ("v2", "v1"):
        rt = TS.deserialize(JS.serialize(jwire, format=fmt))
        _eq(C.decompress_wire_tree(rt, device="cpu"), hat)
    # the port's frame, through the port's serialization, into JAX
    tp, that, _ = C.compress_delta(spec, x, ef, key=7, device="cpu")
    twire = C.payload_to_wire(spec, tp, n)
    for fmt in ("v2", "v1"):
        rt = JS.deserialize(TS.serialize(twire, format=fmt))
        _eq(JC.decompress_wire_tree(rt), that)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_injected_draws_give_byte_identical_frames(spec, eager_jax):
    n, x, ef = 300, _vec(4), 0.2 * _vec(5)
    key = jax.random.key(11)
    jp, jhat, jef = JC.compress_delta(_jspec(spec), x, ef, key=key)
    noise = _u(key, n, spec.chunk) if spec.int8 else None
    tp, that, tef = C.compress_delta(spec, torch.from_numpy(x),
                                     torch.from_numpy(ef), noise=noise)
    _eq(that, jhat)
    _eq(tef, jef)
    jframe = JS.serialize(JC.payload_to_wire(_jspec(spec), jp, n), "v2")
    tframe = TS.serialize(C.payload_to_wire(spec, tp, n), "v2")
    assert tframe == jframe


def test_wire_payload_is_smaller_than_the_dense_frame():
    spec = CompressorSpec(topk_ratio=0.05, int8=True)
    x = _vec(6, 20_000)
    payload, _, _ = C.compress_delta(spec, x, key=2, device="cpu")
    dense = len(TS.serialize({"delta": x}, format="v2"))
    comp = len(TS.serialize(C.payload_to_wire(spec, payload, x.size), "v2"))
    assert dense / comp > 4.0


# ------------------------------------------------------------ tree packing
def test_skeleton_walks_insertion_order():
    """Dict keys out of sorted order: the host plane keeps insertion
    order, as the JAX package does, not ``_tree``'s sorted order."""
    rng = np.random.default_rng(7)
    tree = {
        "z": rng.normal(size=(2, 3)).astype(np.float32),
        "a": rng.normal(size=4).astype(np.float32),
        "m": [{"k": rng.normal(size=(2, 2)).astype(np.float32),
               "b": np.float32(2.5)}],
    }
    sk = C.tree_skeleton(tree)
    assert sk == JC.tree_skeleton(tree)
    assert list(sk) == ["z", "a", "m"]
    flat = C.flatten_host(tree)
    _eq(flat, JC.flatten_host(tree))
    _eq(flat[:6], tree["z"].ravel())
    # torch leaves pack the same way
    ttree = {"z": torch.from_numpy(tree["z"]), "a": torch.from_numpy(
        tree["a"]), "m": [{"k": torch.from_numpy(tree["m"][0]["k"]),
                           "b": torch.tensor(2.5)}]}
    assert C.tree_skeleton(ttree) == sk
    _eq(C.flatten_host(ttree), flat)
    out = C.rebuild_from_skeleton(json.loads(json.dumps(sk)), flat)
    assert list(out) == ["z", "a", "m"]
    for got, want in ((out["z"], tree["z"]), (out["a"], tree["a"]),
                      (out["m"][0]["k"], tree["m"][0]["k"]),
                      (out["m"][0]["b"], tree["m"][0]["b"])):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        _eq(got, want)


def test_tuples_come_back_as_tuples_namedtuples_refused():
    tree = (np.ones(4, np.float32), {"b": np.arange(2, dtype=np.float32)})
    sk = json.loads(json.dumps(C.tree_skeleton(tree)))
    assert sk == JC.tree_skeleton(tree)
    out = C.rebuild_from_skeleton(sk, C.flatten_host(tree))
    assert isinstance(out, tuple) and isinstance(out[1], dict)
    # a JAX DeltaCompressor frame of a tuple tree decodes as a tuple
    jdc = JC.DeltaCompressor(JC.CompressorSpec(topk_ratio=1.0))
    rt = C.decompress_wire_tree(
        TS.deserialize(JS.serialize(jdc.compress(tree), "v2")), device="cpu")
    assert isinstance(rt, tuple)
    _eq(rt[0], tree[0])
    _eq(rt[1]["b"], tree[1]["b"])
    Point = collections.namedtuple("Point", "x y")
    for mod in (C, JC):
        with pytest.raises(TypeError, match="NamedTuple"):
            mod.tree_skeleton(Point(np.ones(2), np.zeros(2)))


def test_bfloat16_leaf_round_trips():
    w = torch.linspace(-2, 2, 16, dtype=torch.bfloat16).reshape(4, 4)
    sk = json.loads(json.dumps(C.tree_skeleton({"w": w})))
    assert sk == JC.tree_skeleton({"w": jnp.asarray(
        np.asarray(w.float()), jnp.bfloat16)})
    assert sk["w"]["dtype"] == "bfloat16"
    out = C.rebuild_from_skeleton(sk, C.flatten_host({"w": w}))
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], w)
    assert C.tree_skeleton({"f": torch.ones(2)})["f"]["dtype"] == "<f4"
    dc = C.DeltaCompressor(CompressorSpec(topk_ratio=1.0), device="cpu")
    rt = dc.decompress(dc.compress({"w": w}))
    assert rt["w"].dtype == torch.bfloat16 and torch.equal(rt["w"], w)
    for mod in (C, JC):
        with pytest.raises(ValueError, match="cannot reconstruct"):
            mod._resolve_dtype("void16")


# ------------------------------------------------------ untrusted payloads
def _frames(spec, n):
    """The same delta compressed by each package, as wire dicts."""
    x = _vec(8, n)
    jp, _, _ = JC.compress_with_feedback(_jspec(spec), jnp.asarray(x),
                                         jnp.zeros(n), jax.random.key(0))
    tp, _, _ = C.compress_delta(spec, x, key=0, device="cpu")
    return (JC.payload_to_wire(_jspec(spec), jp, n),
            C.payload_to_wire(spec, tp, n))


SPARSE = CompressorSpec(topk_ratio=0.2, int8=True, chunk=32)
DENSE8 = CompressorSpec(int8=True, chunk=32)
TAMPER = {
    "not_a_payload": (SPARSE, 150, lambda w: {"method": "avg"}),
    "n_huge": (SPARSE, 150, lambda w: {**w, "n": 10**12}),
    "n_negative": (SPARSE, 150, lambda w: {**w, "n": -1}),
    "n_not_int": (SPARSE, 150, lambda w: {**w, "n": "many"}),
    "sparse_size": (SPARSE, 150, lambda w: {**w, "n": 149}),
    "missing_sparse": (SPARSE, 150, lambda w: {
        k: v for k, v in w.items() if k != "sparse"}),
    "missing_scales": (SPARSE, 150, lambda w: {
        k: v for k, v in w.items() if k != "scales"}),
    "short_q": (DENSE8, 96, lambda w: {**w, "q": w["q"][:10]}),
    "short_scales": (DENSE8, 96, lambda w: {**w, "scales": w["scales"][:1]}),
    "bad_spec": (SPARSE, 150, lambda w: {**w, "spec": {"topk_ratio": 2.0}}),
}


@pytest.mark.parametrize("case", sorted(TAMPER))
def test_malformed_payloads_rejected_as_the_reference_does(case):
    spec, n, tamper = TAMPER[case]
    jwire, twire = _frames(spec, n)
    with pytest.raises(ValueError) as jerr:
        JC.wire_to_payload(tamper(jwire))
    with pytest.raises(ValueError) as terr:
        C.wire_to_payload(tamper(twire))
    assert str(terr.value) == str(jerr.value)
    # and the tampered JAX frame, over the wire into the port, likewise
    rt = TS.deserialize(JS.serialize(tamper(jwire), "v2"))
    with pytest.raises(ValueError) as rerr:
        C.wire_to_payload(rt)
    assert str(rerr.value) == str(jerr.value)


def test_max_elements_cap_is_overridable(monkeypatch):
    _, twire = _frames(SPARSE, 150)
    monkeypatch.setenv("V6T_COMPRESS_MAX_ELEMENTS", "100")
    with pytest.raises(ValueError, match="outside"):
        C.wire_to_payload(twire)
    monkeypatch.setenv("V6T_COMPRESS_MAX_ELEMENTS", "200")
    assert C.wire_to_payload(twire)[2] == 150


def test_tampered_sparse_indices_rejected_by_the_decode():
    _, twire = _frames(SPARSE, 150)
    twire["sparse"].indices[3] = 10_000
    with pytest.raises(ValueError):
        C.decompress_wire_tree(TS.deserialize(TS.serialize(twire, "v2")),
                               device="cpu")


# ------------------------------------------------- env and the compressor
@pytest.mark.parametrize("raw", [None, "off", "", "topk=0.1,int8",
                                 "topk=0.1,int8,chunk=128,no-ef", "int8"])
def test_spec_from_env_matches_the_reference(raw):
    env = {} if raw is None else {"V6T_COMPRESS": raw}
    ours, theirs = C.spec_from_env(env), JC.spec_from_env(env)
    if theirs is None:
        assert ours is None
    else:
        assert dataclasses_eq(ours, theirs)


def dataclasses_eq(a, b):
    return all(getattr(a, f) == getattr(b, f) for f in (
        "topk_ratio", "int8", "chunk", "error_feedback"))


def test_spec_from_env_errors():
    for mod in (C, JC):
        with pytest.raises(ValueError, match="unknown knob"):
            mod.spec_from_env({"V6T_COMPRESS": "topk=0.1,zstd"})
        with pytest.raises(ValueError, match="topk_ratio"):
            mod.spec_from_env({"V6T_COMPRESS": "topk=3.0"})


def test_delta_compressors_draw_their_own_noise():
    spec = CompressorSpec(int8=True, chunk=16)
    tree = {"w": np.linspace(-1, 1, 64, dtype=np.float32)}
    a = C.DeltaCompressor(spec, device="cpu")
    b = C.DeltaCompressor(spec, device="cpu")
    assert a._seed != b._seed  # os.urandom per instance
    qa, qb = a.compress(tree)["q"], b.compress(tree)["q"]
    assert not np.array_equal(qa, qb)
    # an exchange replays from its generator: the same frame (the
    # compressor's first exchange is number 0)
    flat = C.flatten_host(tree)
    p, _, _ = C.compress_delta(spec, flat, key=a.generator(0, flat.device))
    _eq(C.payload_to_wire(spec, p, 64)["q"], qa)
    if not torch.cuda.is_available():  # the entry-point rule
        with pytest.raises(RuntimeError, match="device='cpu'"):
            C.DeltaCompressor(spec)


def test_compressor_names_keep_their_accumulators():
    dc = C.DeltaCompressor(CompressorSpec(topk_ratio=0.2, int8=True),
                           device="cpu")
    tree = {"w": np.arange(100, dtype=np.float32)}
    wire = dc.compress(tree)
    assert C.is_wire_payload(wire)
    assert dc.decompress(wire)["w"].shape == (100,)
    dc.compress(tree, name="other")
    assert set(dc._ef) == {"update", "other"}
    ident = C.DeltaCompressor(CompressorSpec(), device="cpu")
    assert ident.compress(tree) is tree


def test_concurrent_same_name_compresses_serialize():
    dc = C.DeltaCompressor(CompressorSpec(topk_ratio=1.0), device="cpu")
    tree = {"w": np.arange(64, dtype=np.float32)}

    def worker():
        for _ in range(5):
            dc.compress(tree, name="update")

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert dc._seq == 20
    assert torch.equal(dc._ef["update"], torch.zeros(64))


# ------------------------------------------------------------- host plane
def _fed(pkg, spec, n_stations=3):
    root = "vantage6_tpu" if pkg == "jax" else "vantage6_tpu_torch"
    cfgm = importlib.import_module(f"{root}.core.config")
    ctx = importlib.import_module(f"{root}.algorithm.context")
    Fed = importlib.import_module(f"{root}.runtime.federation").Federation

    def partial_delta(scale=1.0):
        env = ctx.current_environment()
        s = env.metadata.node_id + 1
        delta = {
            "w": np.linspace(-scale, scale * s, 400).astype(np.float32),
            "b": np.arange(8, dtype=np.float32) * scale,
        }
        return env.client.compress_update(delta)

    spec = None if spec is None else (
        _jspec(spec) if pkg == "jax" else spec)
    cfg = cfgm.FederationConfig(
        name="comp", compressor=spec, executor_workers=0,
        stations=[cfgm.StationConfig(
            name=f"s{i}", organization=f"org_{i}",
            databases=[cfgm.DatabaseConfig(label="default", type="array")])
            for i in range(n_stations)],
    )
    kw = {} if pkg == "jax" else {"device": "cpu"}
    fed = Fed(cfg, algorithms={"img": {"partial_delta": partial_delta}},
              **kw)
    fed.set_datasets("default", [np.zeros(2)] * n_stations)
    return fed


def _task(fed, **kw):
    t = fed.create_task("img", {"method": "partial_delta", "kwargs": kw})
    return t, fed.wait_for_results(t.id)


def test_error_feedback_advances_across_tasks():
    fed = _fed("torch", CompressorSpec(topk_ratio=0.1, int8=True, chunk=64))
    _, res1 = _task(fed, scale=2.0)
    assert all(C.is_wire_payload(r) for r in res1)
    dense = fed.decompress_update(res1[0])
    assert dense["w"].shape == (400,) and dense["b"].shape == (8,)
    store = fed._delta_compressor._ef
    assert {f"{i}:update" for i in range(3)} <= set(store)
    before = store["0:update"].clone()
    assert before.abs().sum() > 0
    _task(fed, scale=2.0)
    assert not torch.equal(before, store["0:update"])
    fed.close()


def test_host_plane_matches_the_jax_federation():
    """Top-k without int8 draws nothing: both federations ship the same
    payloads, and their EF stores evolve the same, task after task."""
    spec = CompressorSpec(topk_ratio=0.1)
    feds = {p: _fed(p, spec) for p in ("jax", "torch")}
    for scale in (1.0, 3.0):
        res = {p: _task(f, scale=scale)[1] for p, f in feds.items()}
        for jr, tr in zip(res["jax"], res["torch"]):
            assert (TS.serialize(tr, "v2") == JS.serialize(jr, "v2"))
            theirs = feds["jax"].decompress_update(jr)
            ours = feds["torch"].decompress_update(tr)
            for k in ("w", "b"):
                _eq(ours[k], theirs[k])
    for i in range(3):
        _eq(feds["torch"]._delta_compressor._ef[f"{i}:update"],
            feds["jax"]._delta_compressor._ef[f"{i}:update"])
    for f in feds.values():
        f.close()


def test_result_wire_bytes_reflect_compression():
    fed = _fed("torch", CompressorSpec(topk_ratio=0.05, int8=True))
    t, _ = _task(fed)
    for r in t.runs:
        assert r.result_wire_bytes is not None
        assert r.result_wire_bytes < 408 * 4
    fed.close()


def test_passthrough_without_compressor():
    fed = _fed("torch", None)
    _, res = _task(fed)
    assert isinstance(res[0], dict) and "w" in res[0]
    assert not C.is_wire_payload(res[0])
    assert fed.decompress_update(res[0]) is res[0]
    fed.close()


def test_spans_and_telemetry_on_host_plane():
    from vantage6_tpu_torch.common.telemetry import REGISTRY
    from vantage6_tpu_torch.runtime.tracing import TRACER

    fed = _fed("torch", CompressorSpec(topk_ratio=0.2, int8=True))
    before = REGISTRY.snapshot()
    with TRACER.span("test.root", kind="test") as root:
        _, res = _task(fed)
        fed.decompress_update(res[0])
        trace_id = root.context.trace_id
    names = [s["name"] for s in TRACER.drain(trace_id)]
    assert names.count("device.compress") == 3
    assert "device.decompress" in names
    after = REGISTRY.snapshot()
    assert after["v6t_compress_calls_total"] >= (
        before.get("v6t_compress_calls_total", 0) + 3)
    assert after["v6t_decompress_calls_total"] >= (
        before.get("v6t_decompress_calls_total", 0) + 1)
    assert after["v6t_compress_ratio"] > 1.0
    fed.close()


def test_record_round_telemetry_and_fused_wire_plan_match():
    spec = CompressorSpec(topk_ratio=0.1, int8=True)
    for s in (spec, None, CompressorSpec()):
        js = None if s is None else _jspec(s)
        assert C.fused_wire_plan(s, 421_642, 32, 5) == JC.fused_wire_plan(
            js, 421_642, 32, 5)
