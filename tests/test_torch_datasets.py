"""The port's copy of the data generators against the JAX package's: the
same seeds give byte-identical arrays (np.array_equal), so both packages
train on the same shards."""
import gzip
import importlib
import struct

import numpy as np
import pytest

from vantage6_tpu_torch.utils import datasets as td

jd = importlib.import_module("vantage6_tpu.utils.datasets")


def _assert_same(ours, theirs):
    if isinstance(theirs, (tuple, list)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _assert_same(a, b)
        return
    assert ours.dtype == theirs.dtype
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("kw", [dict(n=64), dict(n=33, seed=7, noise=2.0),
                                dict(n=10, n_classes=3, shape=(8, 8, 2),
                                     template_seed=5)])
def test_synthetic_image_classes_identical(kw):
    _assert_same(td.synthetic_image_classes(**kw),
                 jd.synthetic_image_classes(**kw))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_tabular_identical(seed):
    _assert_same(td.synthetic_tabular(50, n_features=6, seed=seed),
                 jd.synthetic_tabular(50, n_features=6, seed=seed))


@pytest.mark.parametrize("n_stations", [3, 4])
def test_partitions_and_padding_identical(n_stations):
    x, y = jd.synthetic_image_classes(97, seed=1)
    _assert_same(td.partition_iid(x, y, n_stations, seed=2),
                 jd.partition_iid(x, y, n_stations, seed=2))
    ours = td.partition_dirichlet(x, y, n_stations, alpha=0.5, seed=3)
    theirs = jd.partition_dirichlet(x, y, n_stations, alpha=0.5, seed=3)
    _assert_same(ours, theirs)
    _assert_same(td.pad_shards(ours), jd.pad_shards(theirs))
    _assert_same(td.pad_shards(ours, pad_to=64),
                 jd.pad_shards(theirs, pad_to=64))
    with pytest.raises(ValueError, match="exceeds pad_to"):
        td.pad_shards(ours, pad_to=1)


def _write_idx(path, arr):
    head = struct.pack(">HBB", 0, 0x08, arr.ndim)
    head += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_load_mnist_from_idx_pair(tmp_path, suffix):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(5, 28, 28))
    labels = rng.integers(0, 10, size=5)
    _write_idx(tmp_path / f"train-images-idx3-ubyte{suffix}", images)
    _write_idx(tmp_path / f"train-labels-idx1-ubyte{suffix}", labels)
    ours = td.load_mnist(tmp_path)
    _assert_same(ours, jd.load_mnist(tmp_path))
    assert ours[0].shape == (5, 28, 28, 1) and ours[1].dtype == np.int32
    assert td.load_mnist(tmp_path, split="test") is None
    # real data wins over the synthetic generator in image_classes
    _assert_same(td.image_classes(8, seed=1, data_dir=tmp_path),
                 jd.image_classes(8, seed=1, data_dir=tmp_path))


def test_load_mnist_from_npz_and_bad_idx(tmp_path):
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "mnist.npz",
             x_train=rng.integers(0, 256, (4, 28, 28), dtype=np.uint8),
             y_train=rng.integers(0, 10, 4, dtype=np.uint8),
             x_test=rng.integers(0, 256, (2, 28, 28), dtype=np.uint8),
             y_test=rng.integers(0, 10, 2, dtype=np.uint8))
    for split in ("train", "test"):
        _assert_same(td.load_mnist(tmp_path, split=split),
                     jd.load_mnist(tmp_path, split=split))
    bad = tmp_path / "bad"
    bad.write_bytes(struct.pack(">HBB", 1, 0x08, 1) + b"\0" * 8)
    with pytest.raises(ValueError, match="not an IDX file"):
        td._read_idx(bad)
    bad.write_bytes(struct.pack(">HBBI", 0, 0x0D, 1, 1) + b"\0" * 4)
    with pytest.raises(ValueError, match="unsupported IDX dtype"):
        td._read_idx(bad)


def test_image_classes_falls_back_to_synthetic(tmp_path, monkeypatch):
    monkeypatch.setenv("V6T_MNIST_DIR", str(tmp_path))
    assert td.load_mnist() is None
    _assert_same(td.image_classes(40, seed=4, noise=2.0),
                 jd.image_classes(40, seed=4, noise=2.0))
