"""The port's secure-average workloads against the JAX package's, on
the CPU, on the same seeded frames (3 stations, two NaN in station 1's
column, skipped by sum and count as pandas does).

Every partial of both packages under one fixed tag gives the same upload
bit for bit (the seeded, DH and Bonawitz uploads, the Bonawitz share and
reveal rounds, the adverts), and the seeded, DH and Bonawitz centrals
through each package's ``federation_from_datasets`` (the port on
``device="cpu"``) give equal counts and averages within 1e-3.
"""
import importlib

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch import native
from vantage6_tpu_torch.algorithm.context import (
    AlgorithmEnvironment,
    algorithm_environment,
)
from vantage6_tpu_torch.common import secureagg_dh as dh
from vantage6_tpu_torch.runtime.federation import federation_from_datasets
from vantage6_tpu_torch.workloads import secure_average

JSA = importlib.import_module("vantage6_tpu.workloads.secure_average")
JCTX = importlib.import_module("vantage6_tpu.algorithm.context")
jax_federation = importlib.import_module(
    "vantage6_tpu.runtime.federation").federation_from_datasets


def _nan_stations():
    """3 stations; station 1's column holds two NaN."""
    rng = np.random.default_rng(23)
    cols = [{"age": rng.normal(45 + 4 * i, 6, 40 + 10 * i)} for i in range(3)]
    cols[1]["age"][[3, 17]] = np.nan
    return cols


def _envs(secret):
    return (AlgorithmEnvironment(station_secret=secret),
            JCTX.AlgorithmEnvironment(station_secret=secret))


class TestPartialsAgainstJax:
    """Every partial of both packages under one fixed tag: the same
    upload, bit for bit (the port on dicts and on DataFrames, the JAX
    package on DataFrames)."""

    TAG = "fixed-tag-0001"

    def test_seeded_partial(self):
        cols = _nan_stations()
        seed_hex = "5a" * 32
        scale = 2.0**30 / (3 * 2.0**16)
        for i, c in enumerate(cols):
            want = JSA.partial_secure_average.plain(
                pd.DataFrame(c), "age", seed_hex, i, 3, scale, 2.0**16,
                self.TAG)
            for frame in (c, pd.DataFrame(c)):
                got = secure_average.partial_secure_average.plain(
                    frame, "age", seed_hex, i, 3, scale, 2.0**16, self.TAG)
                assert got["party_index"] == want["party_index"] == i
                np.testing.assert_array_equal(got["masked"], want["masked"])
        # the NaN are skipped by sum and count: the masks cancel to
        # pandas' sum and count
        ups = np.stack([secure_average.partial_secure_average.plain(
            c, "age", seed_hex, i, 3, scale, 2.0**16, self.TAG)["masked"]
            for i, c in enumerate(cols)])
        total = native.unmask_sum(ups, scale)
        pooled = pd.concat([pd.DataFrame(c) for c in cols])["age"]
        assert int(round(float(total[1]))) == pooled.count() == 148
        assert abs(total[0] / total[1] - pooled.mean()) < 1e-3

    @pytest.mark.parametrize("kind", ["dh", "bonawitz"])
    def test_dh_and_bonawitz_partials(self, kind):
        pytest.importorskip("cryptography")
        cols = _nan_stations()
        secrets_ = [bytes([40 + i]) * 32 for i in range(3)]
        pubkeys = [[i, dh.derive_keypair(s, self.TAG)[1]]
                   for i, s in enumerate(secrets_)]
        scale = 2.0**30 / (3 * 2.0**16)
        name = ("partial_secure_average_dh" if kind == "dh"
                else "partial_secure_average_bonawitz")
        for i, c in enumerate(cols):
            ours_env, jax_env = _envs(secrets_[i])
            with JCTX.algorithm_environment(jax_env):
                want = getattr(JSA, name).plain(
                    pd.DataFrame(c), "age", i, pubkeys, scale, 2.0**16,
                    self.TAG)
                adv_j = JSA.partial_advertise_mask_key(i, self.TAG)
            with algorithm_environment(ours_env):
                adv_t = secure_average.partial_advertise_mask_key(i, self.TAG)
                for frame in (c, pd.DataFrame(c)):
                    got = getattr(secure_average, name).plain(
                        frame, "age", i, pubkeys, scale, 2.0**16, self.TAG)
                    np.testing.assert_array_equal(got["masked"],
                                                  want["masked"])
            assert adv_t == adv_j == {"party_index": i,
                                      "pubkey": pubkeys[i][1]}

    def test_bonawitz_share_and_reveal_partials(self):
        pytest.importorskip("cryptography")
        secrets_ = [bytes([60 + i]) * 32 for i in range(4)]
        pubkeys = [[i, dh.derive_keypair(s, self.TAG)[1]]
                   for i, s in enumerate(secrets_)]
        shares = {}
        for i in range(4):
            ours_env, jax_env = _envs(secrets_[i])
            with JCTX.algorithm_environment(jax_env):
                want = JSA.partial_bonawitz_shares(i, pubkeys, self.TAG, 3)
            with algorithm_environment(ours_env):
                got = secure_average.partial_bonawitz_shares(
                    i, pubkeys, self.TAG, 3)
            assert got == want
            shares[i] = got["blobs"]
        survivors = [0, 1, 3]
        for i in survivors:
            blobs_from = [[o, b] for o in range(4) if o != i
                          for peer, b in shares[o] if peer == i]
            ours_env, jax_env = _envs(secrets_[i])
            with JCTX.algorithm_environment(jax_env):
                want = JSA.partial_bonawitz_reveal(
                    i, pubkeys, blobs_from, survivors, self.TAG, 3)
            with algorithm_environment(ours_env):
                got = secure_average.partial_bonawitz_reveal(
                    i, pubkeys, blobs_from, survivors, self.TAG, 3)
            assert got == want


def _central(fed, image, method, **kwargs):
    task = fed.create_task(image, {"method": method, "kwargs": kwargs},
                           organizations=[0])
    return fed.wait_for_results(task.id)[0]


@pytest.mark.parametrize("method,kwargs", [
    ("central_secure_average", {"seed_hex": "c3" * 32}),
    ("central_secure_average_dh", {}),
    ("central_secure_average_bonawitz", {"poll_interval": 0.02}),
])
def test_centrals_through_both_federations(method, kwargs):
    """Each central through the JAX package's Federation and the port's
    on the same frames (one NaN-holding station): equal counts, averages
    within 1e-3 of each other and of pandas' pooled mean."""
    if method != "central_secure_average":
        pytest.importorskip("cryptography")
    cols = _nan_stations()
    jfed = jax_federation([pd.DataFrame(c) for c in cols], {"sa": JSA})
    tfed = federation_from_datasets(cols, {"sa": secure_average},
                                    device="cpu")
    try:
        want = _central(jfed, "sa", method, column="age", max_abs=2.0**16,
                        **kwargs)
        got = _central(tfed, "sa", method, column="age", max_abs=2.0**16,
                       **kwargs)
    finally:
        jfed.close()
        tfed.close()
    pooled = pd.concat([pd.DataFrame(c) for c in cols])["age"]
    assert got["count"] == want["count"] == pooled.count()
    assert abs(got["average"] - want["average"]) < 1e-3
    assert abs(got["average"] - pooled.mean()) < 1e-3
    assert set(got) == set(want)
    if method == "central_secure_average_bonawitz":
        assert got["dropped"] == want["dropped"] == []
        assert got["n_parties"] == want["n_parties"] == 3
