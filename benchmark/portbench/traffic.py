"""Traffic generators, seeded by the run's ``--seed``.

Copies of the program's generators, rewritten where the benchmark needs it,
so that the program receives only the tensors made here:

- ``federated_tokens``: ``make_federated_tokens`` (each station's tokens
  drawn around a station-distinct centre of the vocabulary, non-IID),
  drawn on the card from a ``torch.Generator`` a round at a time;
- ``image_classes``, ``partition_dirichlet``, ``pad_shards``: the synthetic
  image classes (a fixed template per class plus Gaussian noise), the
  Dirichlet label-skew split and the padding behind
  ``make_federated_data``, in numpy;
- ``batch_indices`` and ``uniform_noise``: a FedAvg round's example indices
  and its int8 rounding noise, drawn on the card.
"""
from __future__ import annotations

import numpy as np
import torch

# seeds are any whole number; generators take them modulo 2**63
SEED_MOD = 2**63


def seed_of(seed: int, stream: int) -> int:
    """A generator seed for one stream of the run's draws: streams of one
    run never share a seed, and the same (seed, stream) gives the same."""
    return (int(seed) * 1000003 + stream) % SEED_MOD


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, stream))


# ------------------------------------------------------------ token streams
def federated_tokens(gen: torch.Generator, n_stations: int, batch: int,
                     seq_len: int, vocab: int) -> torch.Tensor:
    """``[S, B, T]`` int64 token ids on ``gen``'s device: station ``s``
    draws ``round(N((s + 1) * vocab // (S + 1), vocab / 6))`` clipped to
    the vocabulary, as ``make_federated_tokens`` does."""
    device = gen.device
    centre = torch.tensor([(s + 1) * vocab // (n_stations + 1)
                           for s in range(n_stations)],
                          dtype=torch.float32, device=device)
    z = torch.randn((n_stations, batch, seq_len), generator=gen,
                    device=device)
    vals = torch.round(centre[:, None, None] + (vocab / 6) * z)
    return vals.clamp_(0, vocab - 1).to(torch.int64)


# ------------------------------------------------------------ image classes
def image_classes(n: int, seed: int, noise: float, n_classes: int = 10,
                  shape: tuple[int, int, int] = (28, 28, 1),
                  template_seed: int = 1234
                  ) -> tuple[np.ndarray, np.ndarray]:
    """``n`` MNIST-shaped examples: a class template, fixed by
    ``template_seed`` whatever the seed, plus ``noise`` times N(0, 1)."""
    rng = np.random.default_rng(seed)
    templates = (np.random.default_rng(template_seed)
                 .normal(size=(n_classes, *shape)).astype(np.float32))
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = templates[labels] + noise * rng.normal(size=(n, *shape)).astype(
        np.float32)
    return x, labels


def partition_dirichlet(x: np.ndarray, y: np.ndarray, n_stations: int,
                        alpha: float, seed: int
                        ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Label skew: each class split over the stations in proportions drawn
    from Dirichlet(alpha); ragged shards."""
    rng = np.random.default_rng(seed)
    station_idx: list[list[int]] = [[] for _ in range(n_stations)]
    for c in np.unique(y):
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


def pad_shards(shards: list[tuple[np.ndarray, np.ndarray]], pad_to: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shards zero-padded to ``pad_to`` rows (to a multiple of 256 above
    the largest shard, if one is larger) and stacked: ``x [S, n_pad, ...]``,
    ``y [S, n_pad]``, true ``counts [S]`` (float32)."""
    largest = max(len(sx) for sx, _ in shards)
    n_pad = pad_to if largest <= pad_to else -(-largest // 256) * 256
    xs, ys = [], []
    for sx, sy in shards:
        pad = n_pad - len(sx)
        xs.append(np.concatenate([sx, np.zeros((pad, *sx.shape[1:]),
                                               sx.dtype)]))
        ys.append(np.concatenate([sy, np.zeros(pad, sy.dtype)]))
    counts = np.asarray([len(sx) for sx, _ in shards], np.float32)
    return np.stack(xs), np.stack(ys), counts


def federated_images(seed: int, n_stations: int, per_station: int,
                     alpha: float, noise: float, pad_to: int
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The flagship's data: ``n_stations * per_station`` examples split
    Dirichlet(alpha) over the stations, padded and stacked."""
    s = seed % SEED_MOD
    x, y = image_classes(n_stations * per_station, seed=s, noise=noise)
    return pad_shards(partition_dirichlet(x, y, n_stations, alpha, s), pad_to)


# ------------------------------------------------------------ a round's draws
def batch_indices(gen: torch.Generator, counts: torch.Tensor,
                  local_steps: int, batch: int) -> torch.Tensor:
    """``[S, local_steps, batch]`` int64 example indices, uniform in
    ``[0, count)`` for each station, so padded rows are never drawn."""
    u = torch.rand((counts.shape[0], local_steps, batch), generator=gen,
                   device=gen.device)
    n = torch.clamp_min(counts.to(torch.int64), 1).reshape(-1, 1, 1)
    return torch.minimum((u * n.to(torch.float32)).to(torch.int64), n - 1)


def uniform_noise(gen: torch.Generator, n_stations: int,
                  n_pad: int) -> torch.Tensor:
    """``[S, n_pad]`` float32 uniforms in [0, 1): int8 rounding noise."""
    return torch.rand((n_stations, n_pad), generator=gen, device=gen.device)
