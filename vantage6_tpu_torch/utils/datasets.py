"""Synthetic datasets + federated partitioners (numpy only).

The port's own copy of ``vantage6_tpu/utils/datasets.py``: the port may not
import the JAX package, and with the same seed both packages must train on
byte-identical shards (``tests/test_torch_datasets.py`` pins it).

This image has no network and no MNIST on disk, so benchmarks and tests use a
structured synthetic generator: each class gets a fixed random template and
samples are template + noise. A small CNN genuinely has to learn the
templates, so accuracy curves behave like a real (if easy) image task —
enough for convergence tests and for throughput benchmarking, which is
shape-dependent, not content-dependent.

Partitioners mirror the federated reality the reference serves: horizontally
partitioned data across organizations, either iid or Dirichlet non-iid (the
standard FedAvg heterogeneity knob).
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np


def synthetic_image_classes(
    n: int,
    *,
    n_classes: int = 10,
    shape: tuple[int, int, int] = (28, 28, 1),
    noise: float = 0.7,
    seed: int = 0,
    template_seed: int = 1234,
) -> tuple[np.ndarray, np.ndarray]:
    """MNIST-shaped synthetic data: class template + gaussian noise.

    ``template_seed`` fixes the class templates independently of ``seed`` so
    differently-seeded draws (train vs eval) come from the SAME task.
    """
    rng = np.random.default_rng(seed)
    templates = (
        np.random.default_rng(template_seed)
        .normal(size=(n_classes, *shape))
        .astype(np.float32)
    )
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = templates[labels] + noise * rng.normal(size=(n, *shape)).astype(
        np.float32
    )
    return x, labels


def _read_idx(path: Path) -> np.ndarray:
    """IDX (LeCun MNIST format) reader — magic 0x0801 (labels) / 0x0803
    (images); transparently decompresses .gz."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:  # type: ignore[operator]
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: not an IDX file")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        if dtype_code != 0x08:  # ubyte, the only type MNIST uses
            raise ValueError(f"{path}: unsupported IDX dtype {dtype_code:#x}")
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


def load_mnist(
    data_dir: str | Path | None = None, split: str = "train"
) -> tuple[np.ndarray, np.ndarray] | None:
    """Real MNIST from a local directory, if present; else None.

    Makes BASELINE.md's accuracy-parity criterion measurable the moment the
    files exist (no network in this image, so they must be provided). The
    directory — ``data_dir`` arg, else $V6T_MNIST_DIR, else ./data/mnist —
    may hold either:
      - ``mnist.npz`` with arrays x_train/y_train/x_test/y_test (keras
        layout), or
      - the classic IDX pair ``train-images-idx3-ubyte[.gz]`` +
        ``train-labels-idx1-ubyte[.gz]`` (and t10k-* for split="test").

    Returns (x [n,28,28,1] float32 in [0,1], y [n] int32), or None when
    nothing is found — callers fall back to the synthetic generator.
    """
    root = Path(
        data_dir
        or os.environ.get("V6T_MNIST_DIR", "")
        or Path("data") / "mnist"
    )
    npz = root / "mnist.npz"
    if npz.exists():
        with np.load(npz) as z:
            x = z[f"x_{split}"]
            y = z[f"y_{split}"]
    else:
        prefix = "train" if split == "train" else "t10k"
        images = labels = None
        for suffix in ("", ".gz"):
            ip = root / f"{prefix}-images-idx3-ubyte{suffix}"
            lp = root / f"{prefix}-labels-idx1-ubyte{suffix}"
            if ip.exists() and lp.exists():
                images, labels = ip, lp
                break
        if images is None:
            return None
        x = _read_idx(images)
        y = _read_idx(labels)
    x = np.asarray(x, np.float32) / 255.0
    if x.ndim == 3:
        x = x[..., None]
    return x, np.asarray(y, np.int32)


def image_classes(
    n: int,
    *,
    seed: int = 0,
    data_dir: str | Path | None = None,
    noise: float = 0.7,
) -> tuple[np.ndarray, np.ndarray]:
    """n MNIST-shaped examples: REAL MNIST when a local copy exists
    (sampled with `seed`), synthetic templates otherwise — the single entry
    point workloads/benchmarks use. ``noise`` is the synthetic task's
    difficulty knob (ignored on real data): raising it takes few-round
    accuracy below the ceiling so a parity gap has room to show."""
    real = load_mnist(data_dir)
    if real is None:
        return synthetic_image_classes(n, seed=seed, noise=noise)
    x, y = real
    idx = np.random.default_rng(seed).choice(
        len(x), size=n, replace=n > len(x)
    )
    return x[idx], y[idx]


def synthetic_tabular(
    n: int,
    *,
    n_features: int = 16,
    seed: int = 0,
    noise: float = 0.5,
) -> tuple[np.ndarray, np.ndarray]:
    """Linearly separable-ish binary tabular data for logistic regression."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=n_features).astype(np.float32)
    x = rng.normal(size=(n, n_features)).astype(np.float32)
    logits = x @ w + noise * rng.normal(size=n).astype(np.float32)
    y = (logits > 0).astype(np.float32)
    return x, y


def partition_iid(
    x: np.ndarray, y: np.ndarray, n_stations: int, seed: int = 0
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Shuffle + equal split. Truncates the remainder so shards are
    homogeneous (SPMD static shapes; see partition_padded for ragged)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    per = len(x) // n_stations
    return [
        (x[idx[i * per:(i + 1) * per]], y[idx[i * per:(i + 1) * per]])
        for i in range(n_stations)
    ]


def partition_dirichlet(
    x: np.ndarray,
    y: np.ndarray,
    n_stations: int,
    alpha: float = 0.5,
    seed: int = 0,
    n_classes: int | None = None,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Non-iid label-skew split: per class, proportions ~ Dirichlet(alpha).

    Low alpha -> strong heterogeneity (each station dominated by few
    classes) — the standard FedAvg stress test. Shards are ragged; pad with
    `pad_shards` before stacking for device mode.
    """
    rng = np.random.default_rng(seed)
    classes = np.unique(y) if n_classes is None else np.arange(n_classes)
    station_idx: list[list[int]] = [[] for _ in range(n_stations)]
    for c in classes:
        c_idx = np.flatnonzero(y == c)
        rng.shuffle(c_idx)
        props = rng.dirichlet([alpha] * n_stations)
        cuts = (np.cumsum(props) * len(c_idx)).astype(int)[:-1]
        for s, part in enumerate(np.split(c_idx, cuts)):
            station_idx[s].extend(part.tolist())
    out = []
    for s in range(n_stations):
        idx = np.asarray(station_idx[s], dtype=int)
        rng.shuffle(idx)
        out.append((x[idx], y[idx]))
    return out


def pad_shards(
    shards: list[tuple[np.ndarray, np.ndarray]],
    pad_to: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ragged shards -> stacked [S, n_max, ...] + labels + true counts.

    SPMD needs static shapes (SURVEY.md §7 hard part 3): short stations are
    zero-padded; `counts` carries true sizes for weighted aggregation and
    batch masking.
    """
    n_max = pad_to or max(len(sx) for sx, _ in shards)
    xs, ys, counts = [], [], []
    for sx, sy in shards:
        n = len(sx)
        if n > n_max:
            raise ValueError(f"shard of {n} exceeds pad_to={n_max}")
        pad_n = n_max - n
        xs.append(np.concatenate([sx, np.zeros((pad_n, *sx.shape[1:]),
                                               sx.dtype)]))
        ys.append(np.concatenate([sy, np.zeros((pad_n, *sy.shape[1:]),
                                               sy.dtype)]))
        counts.append(n)
    return np.stack(xs), np.stack(ys), np.asarray(counts, np.float32)
