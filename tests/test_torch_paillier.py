"""The port's Paillier and its Paillier Kaplan-Meier against the JAX
package's, on the CPU.

The first part is ``tests/test_paillier.py`` with its imports switched to
the port (primitives, masking-path parity, mask domain separation) and
``test_survival.py::TestPaillierKM`` through the port's Federation on
``device="cpu"`` (frames as DataFrames, as the reference's case, and as
dicts of numpy columns). The cross-package cases build both packages' keys
from the same primes: under the same ``r`` the ciphertexts are equal
integers, each package decrypts the other's, and the Paillier KM through
both federations gives exact counts and a survival curve within 1e-12 of
the float64 plain KM. Small keys (512 bits, 256 for the KM), as the
reference's tests.
"""
import importlib
import math

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch import native
from vantage6_tpu_torch.common import paillier
from vantage6_tpu_torch.runtime.federation import federation_from_datasets
from vantage6_tpu_torch.workloads import survival

JP = importlib.import_module("vantage6_tpu.common.paillier")
JS = importlib.import_module("vantage6_tpu.workloads.survival")
jax_federation = importlib.import_module(
    "vantage6_tpu.runtime.federation").federation_from_datasets


@pytest.fixture(scope="module")
def keypair():
    return paillier.keygen(bits=512)  # small for test speed; >=2048 for real


@pytest.fixture(scope="module")
def both_keys():
    """One 512-bit key in both packages: the JAX package's keygen, the
    port's key built from its n, lambda and mu."""
    jpk, jsk = JP.keygen(bits=512)
    tpk = paillier.PublicKey(n=jpk.n)
    tsk = paillier.PrivateKey(public=tpk, lam=jsk.lam, mu=jsk.mu)
    return (tpk, tsk), (jpk, jsk)


# --------------------------------------------- tests/test_paillier.py
class TestPrimitives:
    def test_roundtrip_signed(self, keypair):
        pk, sk = keypair
        for m in (0, 1, -1, 12345, -987654321, 2**40, -(2**40)):
            assert sk.decrypt(pk.encrypt(m)) == m

    def test_homomorphic_add(self, keypair):
        pk, sk = keypair
        c = pk.add(pk.encrypt(1111), pk.encrypt(-2222))
        assert sk.decrypt(c) == -1111

    def test_add_plain_and_mul_plain(self, keypair):
        pk, sk = keypair
        c = pk.encrypt(100)
        assert sk.decrypt(pk.add_plain(c, 23)) == 123
        assert sk.decrypt(pk.mul_plain(c, -3)) == -300

    def test_ciphertexts_are_randomized(self, keypair):
        pk, _ = keypair
        assert pk.encrypt(42) != pk.encrypt(42)

    def test_plaintext_range_enforced(self, keypair):
        pk, _ = keypair
        with pytest.raises(ValueError, match="outside"):
            pk.encrypt(pk.n)

    def test_bad_blinding_rejected(self, keypair):
        pk, _ = keypair
        with pytest.raises(ValueError, match="Z\\*_n"):
            pk.encrypt(1, r=0)

    def test_deterministic_with_fixed_r(self, keypair):
        pk, sk = keypair
        c1, c2 = pk.encrypt(7, r=12345), pk.encrypt(7, r=12345)
        assert c1 == c2 and sk.decrypt(c1) == 7

    def test_vector_sum(self, keypair):
        pk, sk = keypair
        a, b = [1, -2, 3], [10, 20, -30]
        agg = pk.add_vectors(pk.encrypt_vector(a), pk.encrypt_vector(b))
        assert sk.decrypt_vector(agg) == [11, 18, -27]

    def test_keygen_rejects_tiny(self):
        with pytest.raises(ValueError):
            paillier.keygen(bits=32)


class TestParity:
    """masking-path aggregate == paillier-path aggregate, exactly."""

    def test_secure_sum_parity(self, keypair):
        pk, sk = keypair
        rng = np.random.default_rng(0)
        n_stations, dim, scale = 5, 40, 2.0**16
        vectors = [
            rng.normal(0, 3, dim).astype(np.float32)
            for _ in range(n_stations)
        ]

        # (a) native additive-masking path (what nodes actually upload)
        seed = bytes(range(32))
        uploads = [
            native.mask_update(seed, s, n_stations, vectors[s], scale,
                               tag="parity-test")
            for s in range(n_stations)
        ]
        masked_sum_q = native.sum_wrapping(np.stack(uploads))

        # (b) paillier path on the SAME vectors
        paillier_sum = paillier.secure_sum_paillier(pk, sk, vectors, scale)
        paillier_sum_q = np.asarray(
            [int(round(float(v) * scale)) for v in paillier_sum], np.int64
        )

        # identical quantized integers (int32 wrap never triggers here)
        np.testing.assert_array_equal(
            masked_sum_q.astype(np.int64), paillier_sum_q
        )
        # and both match the plain sum within quantization error
        plain = np.sum(np.stack(vectors), axis=0)
        np.testing.assert_allclose(
            native.dequantize(masked_sum_q, scale), plain,
            atol=n_stations / scale
        )

    def test_parity_with_negative_and_zero_stations(self, keypair):
        pk, sk = keypair
        vectors = [
            np.asarray([-1.5, 0.0, 2.25], np.float32),
            np.asarray([0.0, 0.0, 0.0], np.float32),
            np.asarray([1.5, -7.75, 0.5], np.float32),
        ]
        seed = b"\x07" * 32
        scale = 2.0**12
        uploads = [
            native.mask_update(seed, s, 3, vectors[s], scale, tag=b"t2")
            for s in range(3)
        ]
        a = native.unmask_sum(np.stack(uploads), scale)
        b = paillier.secure_sum_paillier(pk, sk, vectors, scale)
        np.testing.assert_array_equal(a, b)


class TestMaskDomainSeparation:
    """The same seed must give INDEPENDENT masks per aggregation —
    identical uploads across two aggregations would let the relay
    difference them and unmask."""

    def test_different_tags_different_masks(self):
        seed = bytes(32)
        v = np.asarray([1.0, 2.0, 3.0], np.float32)
        up1 = native.mask_update(seed, 0, 3, v, tag="agg-1")
        up2 = native.mask_update(seed, 0, 3, v, tag="agg-2")
        assert not np.array_equal(up1, up2)

    def test_same_tag_still_cancels(self):
        seed = bytes(32)
        vs = [np.asarray([float(s)], np.float32) for s in range(4)]
        ups = [native.mask_update(seed, s, 4, vs[s], tag="round-9")
               for s in range(4)]
        out = native.unmask_sum(np.stack(ups))
        np.testing.assert_allclose(out, [6.0], atol=1e-3)


# ------------------------------------------------------ cross-package
def _blinding(rng, n):
    while True:
        r = int.from_bytes(rng.bytes(64), "little") % n
        if r and math.gcd(r, n) == 1:
            return r


class TestAgainstJax:
    def test_keygen_shapes_match(self):
        pk, sk = paillier.keygen(bits=256)
        assert pk.n.bit_length() >= 256
        assert sk.decrypt(pk.encrypt(-5)) == -5
        jpk = JP.PublicKey(n=pk.n)
        jsk = JP.PrivateKey(public=jpk, lam=sk.lam, mu=sk.mu)
        assert jsk.decrypt(pk.encrypt(77)) == 77

    def test_ciphertexts_equal_under_same_r(self, both_keys):
        (tpk, _), (jpk, _) = both_keys
        rng = np.random.default_rng(3)
        ms = [0, 1, -1, 2**40, -(2**40)] + [
            int(v) for v in rng.integers(-2**62, 2**62, 20)]
        for m in ms:
            r = _blinding(rng, tpk.n)
            assert tpk.encrypt(m, r=r) == jpk.encrypt(m, r=r)
        c1, c2 = tpk.encrypt(5, r=7), tpk.encrypt(-9, r=11)
        assert tpk.add(c1, c2) == jpk.add(c1, c2)
        assert tpk.add_plain(c1, 3) == jpk.add_plain(c1, 3)
        assert tpk.mul_plain(c1, -4) == jpk.mul_plain(c1, -4)

    def test_decryption_across_packages(self, both_keys):
        (tpk, tsk), (jpk, jsk) = both_keys
        rng = np.random.default_rng(4)
        ms = [int(v) for v in rng.integers(-2**50, 2**50, 16)]
        from_port = tpk.encrypt_vector(ms)
        from_jax = jpk.encrypt_vector(ms)
        assert jsk.decrypt_vector(from_port) == ms
        assert tsk.decrypt_vector(from_jax) == ms
        agg = tpk.add_vectors(from_port, from_jax)
        assert jsk.decrypt_vector(agg) == [2 * m for m in ms]

    def test_quantize_and_secure_sum_equal(self, both_keys):
        (tpk, tsk), (jpk, jsk) = both_keys
        rng = np.random.default_rng(5)
        vectors = [rng.normal(0, 3, 24).astype(np.float32) for _ in range(4)]
        assert (paillier.quantize(vectors[0], 2.0**16)
                == JP.quantize(vectors[0], 2.0**16))
        np.testing.assert_array_equal(
            paillier.secure_sum_paillier(tpk, tsk, vectors),
            JP.secure_sum_paillier(jpk, jsk, vectors))


# ---------------------- test_survival.py::TestPaillierKM, and both packages
def _km_frames(seed=31, n_st=3, rows=60):
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n_st):
        t = np.ceil(rng.exponential(5, rows)).clip(1, 12)
        e = (rng.uniform(size=rows) < 0.7).astype(float)
        frames.append({"t": t, "e": e})
    grid = sorted(set(float(v) for f in frames for v in f["t"]))
    return frames, grid


def _plain_km(frames, grid):
    tv = np.concatenate([f["t"] for f in frames])
    ev = np.concatenate([f["e"] for f in frames])
    events = [float(((tv == g) * ev).sum()) for g in grid]
    at_risk = [float((tv >= g).sum()) for g in grid]
    surv, s = [], 1.0
    for d, n in zip(events, at_risk):
        s *= 1.0 - d / max(n, 1.0)
        surv.append(s)
    return events, at_risk, surv


def _paillier_km(fed, pk, grid):
    task = fed.create_task(
        "v6-km",
        {
            "method": "central_kaplan_meier_paillier",
            "kwargs": {
                "time_col": "t", "event_col": "e", "grid": grid,
                "public_key_n": hex(pk.n),
            },
        },
        organizations=[0],
    )
    return fed.wait_for_results(task.id)[0]


class TestPaillierKM:
    """BASELINE ladder item 5: KM under Paillier through the task plane —
    stations encrypt, the central node adds ciphertexts blind, only the
    researcher's private key reveals the pooled curve."""

    @pytest.mark.parametrize("kind", ["dataframe", "dict"])
    def test_encrypted_pipeline_matches_plain_km(self, kind):
        frames, grid = _km_frames()
        data = ([pd.DataFrame(f) for f in frames] if kind == "dataframe"
                else frames)
        pk, sk = paillier.keygen(bits=256)  # small key: test speed only
        fed = federation_from_datasets(data, {"v6-km": survival},
                                       device="cpu")
        try:
            out = _paillier_km(fed, pk, grid)
        finally:
            fed.close()
        # the aggregate that crossed the wire is ciphertext, not counts
        assert all(isinstance(c, str) for c in out["events_ct"])
        assert all(isinstance(c, str) for c in out["at_risk_ct"])
        assert out["n_parties"] == 3 and out["grid"] == grid

        km = survival.decrypt_km(sk, out)
        events, at_risk, surv_ref = _plain_km(frames, grid)
        np.testing.assert_allclose(km["survival"], surv_ref, atol=1e-12)
        # and the counts agree with the plaintext partials
        np.testing.assert_array_equal(km["events"], events)
        np.testing.assert_array_equal(km["at_risk"], at_risk)

    def test_partial_counts_from_the_plain_partial(self, keypair):
        """The encrypted partial decrypts to the plain partial's counts."""
        pk, sk = keypair
        frames, grid = _km_frames(seed=5, n_st=1)
        out = survival.partial_km_counts_paillier.plain(
            frames[0], "t", "e", grid, hex(pk.n))
        plain = survival.partial_km_counts.plain(frames[0], "t", "e", grid)
        assert sk.decrypt_vector(int(c, 16) for c in out["events_ct"]) == [
            int(v) for v in plain["events"]]
        assert sk.decrypt_vector(int(c, 16) for c in out["at_risk_ct"]) == [
            int(v) for v in plain["at_risk"]]

    def test_both_federations_agree(self):
        """The same frames and one 256-bit key through the JAX package's
        Federation and the port's: exact counts, survival within 1e-12 of
        the float64 plain KM, and each package's researcher decrypts the
        other's aggregate."""
        frames, grid = _km_frames(seed=8, n_st=4, rows=50)
        jpk, jsk = JP.keygen(bits=256)
        tpk = paillier.PublicKey(n=jpk.n)
        tsk = paillier.PrivateKey(public=tpk, lam=jsk.lam, mu=jsk.mu)
        tfed = federation_from_datasets(frames, {"v6-km": survival},
                                        device="cpu")
        jfed = jax_federation([pd.DataFrame(f) for f in frames],
                              {"v6-km": JS})
        try:
            t_out = _paillier_km(tfed, tpk, grid)
            j_out = _paillier_km(jfed, jpk, grid)
        finally:
            tfed.close()
            jfed.close()
        events, at_risk, surv = _plain_km(frames, grid)
        for km in (survival.decrypt_km(tsk, t_out),
                   JS.decrypt_km(jsk, t_out),
                   survival.decrypt_km(tsk, j_out)):
            np.testing.assert_array_equal(km["events"], events)
            np.testing.assert_array_equal(km["at_risk"], at_risk)
            np.testing.assert_allclose(km["survival"], surv, atol=1e-12)
            assert km["grid"] == grid
