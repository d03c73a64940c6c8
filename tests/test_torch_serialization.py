"""The port's wire format against the JAX package's, byte for byte.

The same payloads go through both ``serialize`` functions and must give
the same bytes; each package decodes the other's frames; the committed
goldens decode in the port; torch tensors encode as their numpy arrays.
The JAX package's own wire tests (``test_wire_format.py``) cover the
format's behaviour; these hold the port to it.
"""
import importlib
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vantage6_tpu_torch.common import serialization as T

J = importlib.import_module("vantage6_tpu.common.serialization")

DATA_DIR = Path(__file__).parent / "data"


def _sparse(mod):
    return mod.SparseVector(np.array([1, 4, 9, 100], np.int32),
                            np.array([0.5, -1.5, 2.0, -3.25], np.float32),
                            128)


def _payloads(mod):
    """Payloads by name, built with ``mod``'s SparseVector."""
    return {
        "arrays": {
            "method": "avg",
            "args": [1, 2.5, "x", None, True],
            "weights": np.arange(12, dtype=np.float32).reshape(3, 4),
            "f16": np.arange(4, dtype=np.float16),
            "i8": np.array([[1, -2], [3, -4]], dtype=np.int8),
            "empty": np.zeros((0, 2)),
            "nested": [{"w": np.ones(3, dtype=np.float64)}, (1, 2)],
        },
        "scalars": {"f32": np.float32(1.5), "i64": np.int64(-7),
                    "f64": np.float64(0.25), "u8": np.uint8(3),
                    1: "int key", None: "none key", 2.5: True},
        "bytes": {"blob": b"\x00\x01\x02v6t", "ba": bytearray(b"xy"),
                  "strided": memoryview(b"abcdef")[::2]},
        "noncontiguous": {"t": np.arange(12.0).reshape(3, 4).T},
        "sparse": {"delta": _sparse(mod), "meta": 7,
                   "q": mod.SparseVector(np.arange(16, dtype=np.int64) * 4,
                                         np.arange(-8, 8, dtype=np.int8), 64),
                   "e": mod.SparseVector(np.array([], np.int32),
                                         np.array([], np.float32), 8)},
    }


PAYLOADS = list(_payloads(J))
FORMATS = ["v1", "v2"]


def assert_tree_equal(a, b):
    if isinstance(a, (J.SparseVector, T.SparseVector)):
        assert a.size == b.size and a.fill == b.fill
        assert_tree_equal(a.indices, b.indices)
        assert_tree_equal(a.values, b.values)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", PAYLOADS)
def test_serialize_gives_the_jax_packages_bytes(name, fmt):
    ours = T.serialize(_payloads(T)[name], format=fmt)
    assert ours == J.serialize(_payloads(J)[name], format=fmt)
    assert T.wire_nbytes(_payloads(T)[name]) == J.wire_nbytes(
        _payloads(J)[name])


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", PAYLOADS)
def test_each_package_decodes_the_others_frames(name, fmt):
    jblob = J.serialize(_payloads(J)[name], format=fmt)
    tblob = T.serialize(_payloads(T)[name], format=fmt)
    assert_tree_equal(T.deserialize(jblob), J.deserialize(jblob))
    assert_tree_equal(J.deserialize(tblob), T.deserialize(tblob))
    assert T.peek_structure(tblob) == J.peek_structure(jblob)


@pytest.mark.parametrize("fmt", FORMATS)
def test_cpu_tensors_encode_as_their_numpy_arrays(fmt):
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f64": rng.standard_normal(4),
              "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
              "i8": np.array([-3, 4], np.int8),
              "bool": np.array([True, False]),
              "empty": np.zeros((0, 3), np.float32)}
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tensors["strided"] = torch.arange(12, dtype=torch.float64).reshape(3, 4).T
    arrays["strided"] = np.arange(12.0).reshape(3, 4).T
    blob = T.serialize({"p": tensors, "l": [tensors["f32"]]}, format=fmt)
    assert blob == J.serialize({"p": arrays, "l": [arrays["f32"]]},
                               format=fmt)
    out = T.deserialize(blob)
    assert_tree_equal(out["p"], {k: np.ascontiguousarray(v)
                                 for k, v in arrays.items()})
    assert T.wire_nbytes({"p": tensors}) == J.wire_nbytes({"p": arrays})


def test_goldens_decode_in_the_port():
    expected_w = np.arange(6, dtype=np.float32).reshape(2, 3) * 0.5
    for name in ("golden_v1.json", "golden_v2.bin"):
        out = T.deserialize((DATA_DIR / name).read_bytes())
        assert out["method"] == "golden"
        assert out["args"] == [1, 2.5, "x", None, True]
        assert np.array_equal(out["weights"], expected_w)
        assert out["weights"].dtype == np.float32
        assert type(out["scalar_f32"]) is np.float32
        assert type(out["scalar_i64"]) is np.int64
        assert out["blob"] == b"\x00\x01\x02v6t"
    out = T.deserialize((DATA_DIR / "golden_v2_sparse.bin").read_bytes())
    assert out["method"] == "golden_sparse"
    sv = out["delta"]
    assert isinstance(sv, T.SparseVector)
    assert np.array_equal(sv.indices, np.array([0, 3, 7, 42, 63]))
    assert np.array_equal(sv.values, np.array([-3, 1, 7, 127, -90], np.int8))
    assert sv.to_dense()[42] == 127


@pytest.mark.parametrize("name", ["golden_v1.json", "golden_v2.bin",
                                  "golden_v2_sparse.bin"])
def test_goldens_reencode_as_the_jax_package_does(name):
    raw = (DATA_DIR / name).read_bytes()
    fmt = "v1" if name.endswith(".json") else "v2"
    assert (T.serialize(T.deserialize(raw), format=fmt)
            == J.serialize(J.deserialize(raw), format=fmt))


def test_bf16_tensor_is_refused_on_v2_and_matches_jax_on_v1():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16)
    j = jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)
    with pytest.raises(TypeError):
        J.serialize({"w": j}, format="v2")
    with pytest.raises(TypeError):
        T.serialize({"w": t}, format="v2")
    blob = T.serialize({"w": t}, format="v1")
    assert blob == J.serialize({"w": j}, format="v1")
    out = T.deserialize(blob)["w"]
    assert out.dtype.kind == "V" and out.dtype.itemsize == 2
    assert out.tobytes() == t.view(torch.int16).numpy().tobytes()


def test_tampered_sparse_indices_rejected():
    blob = T.serialize({"delta": _sparse(T)}, format="v2")
    _, pos = T._read_v2_header(blob)
    bad = bytearray(blob)
    struct.pack_into("<i", bad, T._align(pos), 10**6)
    with pytest.raises(ValueError, match="out of bounds"):
        T.deserialize(bytes(bad))
    tampered = blob.replace(b'"index_dtype":"<i4"', b'"index_dtype":"<f4"')
    with pytest.raises(ValueError, match="integer"):
        T.deserialize(tampered)
    with pytest.raises(ValueError, match="out of bounds"):
        T.SparseVector(np.array([8], np.int32), np.array([1.0], np.float32),
                       8)
