"""The port's per-pair DH mask agreement and Bonawitz secure aggregation
against the JAX package's, on the CPU.

The first part is ``tests/test_secureagg_dh.py`` and
``tests/test_secureagg_bonawitz.py`` (its ``TestShamir`` is in
``test_torch_native.py``) with their imports switched to the port; the
workload cases run the port's Federation on ``device="cpu"``. The
cross-package cases run both packages on the same station secrets, tags
and values: adverts equal and signatures verified across packages, pair
seeds and masked uploads bit for bit, and Bonawitz share blobs, uploads,
reveals and ``recover_sum`` bit for bit with no, one and two dropouts.
Last, a Bonawitz average through the port's Federation with one upload
swallowed by the ``drop`` fault names the dropped station.
"""
import importlib

import numpy as np
import pytest

pytest.importorskip("cryptography")  # X25519 is the module under test

from vantage6_tpu_torch import native
from vantage6_tpu_torch.common import secureagg_bonawitz as bon
from vantage6_tpu_torch.common import secureagg_dh as dh
from vantage6_tpu_torch.common.faults import FAULTS
from vantage6_tpu_torch.runtime.federation import federation_from_datasets
from vantage6_tpu_torch.workloads import secure_average

JDH = importlib.import_module("vantage6_tpu.common.secureagg_dh")
JBON = importlib.import_module("vantage6_tpu.common.secureagg_bonawitz")


def _setup(n, tag="agg-1"):
    secrets_ = [bytes([i + 1]) * 32 for i in range(n)]
    pubs = {}
    for i, sec in enumerate(secrets_):
        _, pub = dh.derive_keypair(sec, tag)
        pubs[i] = pub
    return secrets_, pubs


class TestKeyAgreement:
    def test_pair_seed_agrees_both_ends(self):
        secrets_, pubs = _setup(3)
        priv0, _ = dh.derive_keypair(secrets_[0], "agg-1")
        priv1, _ = dh.derive_keypair(secrets_[1], "agg-1")
        s01 = dh.pairwise_seed(priv0, pubs[1], 0, 1, "agg-1")
        s10 = dh.pairwise_seed(priv1, pubs[0], 0, 1, "agg-1")
        assert s01 == s10 and len(s01) == 32

    def test_pair_seed_differs_per_pair_and_tag(self):
        secrets_, pubs = _setup(3)
        priv0, _ = dh.derive_keypair(secrets_[0], "agg-1")
        assert dh.pairwise_seed(priv0, pubs[1], 0, 1, "agg-1") != (
            dh.pairwise_seed(priv0, pubs[2], 0, 2, "agg-1")
        )
        assert dh.pairwise_seed(priv0, pubs[1], 0, 1, "agg-1") != (
            dh.pairwise_seed(priv0, pubs[1], 0, 1, "agg-2")
        )

    def test_keypair_deterministic_per_tag(self):
        sec = b"\x42" * 32
        _, p1 = dh.derive_keypair(sec, "t")
        _, p2 = dh.derive_keypair(sec, "t")
        _, p3 = dh.derive_keypair(sec, "other")
        assert p1 == p2 != p3

    def test_short_secret_rejected(self):
        with pytest.raises(ValueError, match=">= 16"):
            dh.derive_keypair(b"short", "t")

    def test_mismatched_advertised_key_rejected(self):
        secrets_, pubs = _setup(2)
        pubs[0] = pubs[1]  # station 0's advert corrupted/stale
        with pytest.raises(ValueError, match="does not match"):
            dh.mask_update_dh(
                secrets_[0], 0, pubs, np.ones(3, np.float32), tag="agg-1"
            )


class TestAggregation:
    def test_masks_cancel_exactly(self):
        n, dim, scale = 4, 33, 2.0**16
        rng = np.random.default_rng(5)
        vectors = [rng.normal(0, 2, dim).astype(np.float32) for _ in range(n)]
        secrets_, pubs = _setup(n)
        uploads = [
            dh.mask_update_dh(secrets_[s], s, pubs, vectors[s], scale,
                              tag="agg-1")
            for s in range(n)
        ]
        out = dh.unmask_sum_dh(np.stack(uploads), scale)
        np.testing.assert_allclose(
            out, np.sum(np.stack(vectors), axis=0), atol=n / scale
        )

    def test_two_parties(self):
        secrets_, pubs = _setup(2, tag="t")
        a = dh.mask_update_dh(secrets_[0], 0, pubs,
                              np.asarray([1.5, -2.0], np.float32), tag="t")
        b = dh.mask_update_dh(secrets_[1], 1, pubs,
                              np.asarray([0.25, 0.5], np.float32), tag="t")
        np.testing.assert_allclose(
            dh.unmask_sum_dh(np.stack([a, b])), [1.75, -1.5], atol=1e-3
        )

    def test_missing_upload_leaves_garbage(self):
        """Documented no-dropout-recovery property: without one station's
        upload the pairwise masks do NOT cancel."""
        n = 3
        secrets_, pubs = _setup(n, tag="t")
        vectors = [np.ones(4, np.float32) for _ in range(n)]
        uploads = [
            dh.mask_update_dh(secrets_[s], s, pubs, vectors[s], tag="t")
            for s in range(n - 1)  # last station never uploads
        ]
        partial = dh.unmask_sum_dh(np.stack(uploads))
        assert not np.allclose(partial, [2.0] * 4, atol=1.0)


class TestUntrustedAggregator:
    """The server/aggregator holds ALL public material and still learns
    nothing about an individual update."""

    def test_upload_reveals_nothing_without_private_keys(self):
        n, scale, tag = 3, 2.0**16, "agg-x"
        secrets_, pubs = _setup(n, tag)
        value = np.asarray([123.456, 80.0], np.float32)
        upload = dh.mask_update_dh(secrets_[0], 0, pubs, value, scale, tag)

        # 1) the upload is not the quantized plaintext
        assert not np.array_equal(upload, native.quantize(value, scale))

        # 2) every derivation an aggregator could attempt from PUBLIC
        # material fails to reproduce the masks: keys derived from pubkeys
        # (instead of a private exchange) give different streams
        for fake_seed in (
            bytes.fromhex(pubs[0]),          # a raw public key as key
            bytes.fromhex(pubs[1]),
            native.derive_mask_key(bytes.fromhex(pubs[0]), tag),
        ):
            fake_masks = sum(
                (1 if 0 == min(0, j) else -1)
                * native.chacha20_stream(
                    fake_seed, native.pair_nonce(min(0, j), max(0, j)), 2
                ).astype(np.int64)
                for j in range(1, n)
            )
            reconstructed = (upload.astype(np.int64) - fake_masks) % 2**32
            assert not np.array_equal(
                reconstructed.astype(np.int32),
                native.quantize(value, scale),
            )

        # 3) two stations' secrets DO reproduce their pair seed — only the
        # endpoints can; this is the DH property the protocol rests on
        priv0, _ = dh.derive_keypair(secrets_[0], tag)
        priv1, _ = dh.derive_keypair(secrets_[1], tag)
        assert dh.pairwise_seed(priv0, pubs[1], 0, 1, tag) == (
            dh.pairwise_seed(priv1, pubs[0], 0, 1, tag)
        )

    def test_same_value_different_aggregations_incomparable(self):
        """Across two aggregations (fresh tags) the same plaintext yields
        unrelated uploads — the relay cannot difference them (the ADVICE r1
        unmasking attack on the single-seed path)."""
        secrets_, pubs1 = _setup(2, "round-1")
        _, pubs2 = _setup(2, "round-2")
        v = np.asarray([42.0], np.float32)
        u1 = dh.mask_update_dh(secrets_[0], 0, pubs1, v, tag="round-1")
        u2 = dh.mask_update_dh(secrets_[0], 0, pubs2, v, tag="round-2")
        assert not np.array_equal(u1, u2)


class TestWorkloadEndToEnd:
    def test_central_secure_average_dh_federation(self):
        import pandas as pd

        from vantage6_tpu_torch.runtime.federation import federation_from_datasets
        from vantage6_tpu_torch.workloads import secure_average

        rng = np.random.default_rng(11)
        frames = [
            pd.DataFrame({"age": rng.normal(45 + 5 * i, 6, 80)})
            for i in range(3)
        ]
        fed = federation_from_datasets(
            frames, {"v6-secure-average": secure_average}, device="cpu"
        )
        task = fed.create_task(
            "v6-secure-average",
            {
                "method": "central_secure_average_dh",
                "kwargs": {"column": "age", "max_abs": 2.0**16},
            },
            organizations=[0],
        )
        out = fed.wait_for_results(task.id)[0]
        pooled = pd.concat(frames)["age"]
        assert out["count"] == len(pooled)
        assert abs(out["average"] - pooled.mean()) < 1e-3

        # stored partial results are masked, not plaintext
        scale = 2.0**30 / (3 * 2.0**16)
        for t in fed.tasks.values():
            if t.method != "partial_secure_average_dh":
                continue
            for run in t.runs:
                idx = run.result["party_index"]
                plain = np.asarray(
                    [frames[idx]["age"].sum(), len(frames[idx])], np.float32
                )
                assert not np.array_equal(
                    np.asarray(run.result["masked"]),
                    native.quantize(plain, scale),
                )


class TestSignedAdverts:
    """Active-MitM resistance: X25519 adverts bound to org RSA identity keys
    (VERDICT r2 missing #3). A relay substituting its own DH keys now fails
    closed at every verifying station."""

    @pytest.fixture(scope="class")
    def identities(self):
        from vantage6_tpu_torch.common.encryption import RSACryptor

        return [RSACryptor(RSACryptor.create_new_rsa_key())
                for _ in range(2)]

    def test_substituted_pubkey_fails_closed(self, identities):
        tag = "agg-s"
        secrets_, pubs = _setup(2, tag)
        idents = {i: c.public_key_str for i, c in enumerate(identities)}
        sigs = {
            i: dh.sign_advert(identities[i], i, pubs[i], tag)
            for i in range(2)
        }
        v = np.ones(3, np.float32)
        # honest relay: verification passes, upload proceeds
        up = dh.mask_update_dh(secrets_[0], 0, pubs, v, tag=tag,
                               identities=idents, signatures=sigs)
        assert up.shape == (3,)

        # malicious relay swaps station 1's DH key for its own (classic
        # MitM) but cannot forge the org signature
        from vantage6_tpu_torch.common.secureagg_dh import derive_keypair

        _, evil_pub = derive_keypair(b"\xEE" * 32, tag)
        tampered = dict(pubs)
        tampered[1] = evil_pub
        with pytest.raises(ValueError, match="INVALID"):
            dh.mask_update_dh(secrets_[0], 0, tampered, v, tag=tag,
                              identities=idents, signatures=sigs)

    def test_missing_signature_fails_closed(self, identities):
        tag = "agg-s2"
        secrets_, pubs = _setup(2, tag)
        idents = {i: c.public_key_str for i, c in enumerate(identities)}
        with pytest.raises(ValueError, match="unauthenticated"):
            dh.mask_update_dh(
                secrets_[0], 0, pubs, np.ones(2, np.float32), tag=tag,
                identities=idents, signatures={},
            )

    def test_signature_not_replayable_across_tags_or_stations(self, identities):
        tag = "agg-s3"
        secrets_, pubs = _setup(2, tag)
        idents = {i: c.public_key_str for i, c in enumerate(identities)}
        sigs = {
            i: dh.sign_advert(identities[i], i, pubs[i], tag)
            for i in range(2)
        }
        # same adverts + signatures replayed under a different tag: the
        # canonical message binds the tag, so verification fails
        with pytest.raises(ValueError, match="INVALID"):
            dh.verify_adverts(pubs, idents, sigs, "other-tag")
        # and a signature cannot vouch for a different station index
        swapped = {0: sigs[1], 1: sigs[0]}
        with pytest.raises(ValueError, match="INVALID"):
            dh.verify_adverts(pubs, idents, swapped, tag)


class TestWorkloadSignedAdverts:
    """The DH workload actually uses the signing path end-to-end: adverts
    are signed under the Federation's provisioned identities, stations
    verify rosters, and a substituted pubkey aborts the upload."""

    def test_federation_adverts_are_signed_and_verified(self):
        import pandas as pd

        from vantage6_tpu_torch.runtime.federation import federation_from_datasets
        from vantage6_tpu_torch.workloads import secure_average

        rng = np.random.default_rng(21)
        frames = [
            pd.DataFrame({"age": rng.normal(50, 4, 40)}) for _ in range(2)
        ]
        fed = federation_from_datasets(
            frames, {"v6-secure-average": secure_average}, device="cpu"
        )
        task = fed.create_task(
            "v6-secure-average",
            {
                "method": "central_secure_average_dh",
                "kwargs": {"column": "age", "max_abs": 2.0**16},
            },
            organizations=[0],
        )
        out = fed.wait_for_results(task.id)[0]
        pooled = pd.concat(frames)["age"]
        assert abs(out["average"] - pooled.mean()) < 1e-3
        # every advert that crossed the relay carried a signature
        adverts = [
            run.result
            for t in fed.tasks.values()
            if t.method == "partial_advertise_mask_key"
            for run in t.runs
        ]
        assert adverts and all(a.get("signature") for a in adverts)

    def test_substituted_pubkey_aborts_upload(self):
        import pandas as pd

        from vantage6_tpu_torch.algorithm.context import (
            AlgorithmEnvironment,
            algorithm_environment,
        )
        from vantage6_tpu_torch.common.encryption import RSACryptor
        from vantage6_tpu_torch.workloads.secure_average import (
            partial_secure_average_dh,
        )

        idents = [RSACryptor(RSACryptor.create_new_rsa_key())
                  for _ in range(2)]
        secrets_ = [bytes([7 + i]) * 32 for i in range(2)]
        tag = "agg-e2e"
        pubs = [dh.derive_keypair(s, tag)[1] for s in secrets_]
        sigs = [
            [i, dh.sign_advert(idents[i], i, pubs[i], tag)]
            for i in range(2)
        ]
        registry = {i: c.public_key_str for i, c in enumerate(idents)}
        # the relay swaps party 1's key for its own
        _, evil = dh.derive_keypair(b"\xEE" * 32, tag)
        env = AlgorithmEnvironment(
            dataframes=[pd.DataFrame({"age": [1.0, 2.0]})],
            station_secret=secrets_[0],
            org_identities=registry,
        )
        with algorithm_environment(env):
            with pytest.raises(ValueError, match="INVALID"):
                partial_secure_average_dh(
                    column="age",
                    party_index=0,
                    pubkeys=[[0, pubs[0]], [1, evil]],
                    scale=2.0**10,
                    max_abs=2.0**16,
                    agg_tag=tag,
                    org_ids=[0, 1],
                    signatures=sigs,
                )
            # and a shrunk roster (relay drops party 1 entirely) also fails
            with pytest.raises(ValueError, match="roster"):
                partial_secure_average_dh(
                    column="age",
                    party_index=0,
                    pubkeys=[[0, pubs[0]]],
                    scale=2.0**10,
                    max_abs=2.0**16,
                    agg_tag=tag,
                    org_ids=[0, 1],
                    signatures=sigs,
                )


# ------------------------------ tests/test_secureagg_bonawitz.py
def _run_protocol(n, dim, dropped, tag="agg-1", scale=2.0**12, threshold=None):
    """Drive all four rounds; `dropped` stations advertise + share but never
    upload. Returns (recovered_sum, true_survivor_sum)."""
    rng = np.random.default_rng(7)
    secrets_, pubs = _setup(n, tag)
    vectors = [rng.normal(0, 2, dim).astype(np.float32) for _ in range(n)]
    t = threshold or bon.default_threshold(n)

    # round 2: every station (incl. soon-to-drop ones) distributes shares
    blobs = {
        s: bon.make_recovery_shares(secrets_[s], s, pubs, tag, threshold=t)
        for s in range(n)
    }
    # round 3: survivors upload
    survivors = [s for s in range(n) if s not in dropped]
    uploads = {
        s: bon.mask_update_bonawitz(
            secrets_[s], s, pubs, vectors[s], scale, tag
        )
        for s in survivors
    }
    # round 4: survivors reveal
    reveals = {
        s: bon.reveal_for_recovery(
            secrets_[s], s, pubs,
            {o: blobs[o][s] for o in range(n) if o != s},
            survivors=survivors, tag=tag, threshold=t,
        )
        for s in survivors
    }
    out = bon.recover_sum(uploads, pubs, reveals, tag, threshold=t,
                          scale=scale)
    want = np.sum(np.stack([vectors[s] for s in survivors]), axis=0)
    return out, want


class TestRecovery:
    def test_no_dropout_exact_sum(self):
        out, want = _run_protocol(4, 33, dropped=set())
        np.testing.assert_allclose(out, want, atol=4 / 2.0**12)

    def test_one_dropout_recovers_survivor_sum(self):
        """The VERDICT-cited upgrade of test_missing_upload_leaves_garbage:
        the round now COMPLETES with the survivor-set sum."""
        out, want = _run_protocol(4, 17, dropped={3})
        np.testing.assert_allclose(out, want, atol=4 / 2.0**12)

    def test_two_dropouts(self):
        out, want = _run_protocol(5, 9, dropped={1, 4})
        np.testing.assert_allclose(out, want, atol=5 / 2.0**12)

    def test_below_threshold_unrecoverable(self):
        with pytest.raises(ValueError, match="unrecoverable"):
            _run_protocol(4, 5, dropped={1, 2, 3})

    def test_lying_aggregator_rejected(self):
        """A reveal containing the KEY share of a station that DID upload is
        the signature of an aggregator lying about dropouts to unmask an
        upload it holds; recover_sum fails closed."""
        n, dim, tag, scale = 4, 5, "agg-1", 2.0**12
        secrets_, pubs = _setup(n, tag)
        t = bon.default_threshold(n)
        blobs = {
            s: bon.make_recovery_shares(secrets_[s], s, pubs, tag, threshold=t)
            for s in range(n)
        }
        uploads = {
            s: bon.mask_update_bonawitz(
                secrets_[s], s, pubs, np.ones(dim, np.float32), scale, tag
            )
            for s in range(n)
        }
        # honest stations would never do this; simulate the malicious
        # server's forged reveal claiming station 2 dropped
        reveals = {
            s: bon.reveal_for_recovery(
                secrets_[s], s, pubs,
                {o: blobs[o][s] for o in range(n) if o != s},
                survivors=[x for x in range(n) if x != 2], tag=tag, threshold=t,
            )
            for s in range(n) if s != 2
        }
        with pytest.raises(ValueError, match="protocol violation"):
            bon.recover_sum(uploads, pubs, reveals, tag, threshold=t,
                            scale=scale)

    def test_minority_threshold_rejected_everywhere(self):
        """t <= n/2 would let a lying aggregator show disjoint survivor
        lists to two >= t groups and collect BOTH share types for one
        uploaded station; every entry point must refuse such a threshold."""
        n, tag = 4, "t"
        secrets_, pubs = _setup(n, tag)
        for bad_t in (0, 1, n // 2):
            with pytest.raises(ValueError, match="threshold"):
                bon.make_recovery_shares(
                    secrets_[0], 0, pubs, tag, threshold=bad_t
                )
            with pytest.raises(ValueError, match="threshold"):
                bon.reveal_for_recovery(
                    secrets_[0], 0, pubs, {}, survivors=[0, 1, 2, 3],
                    tag=tag, threshold=bad_t,
                )
            with pytest.raises(ValueError, match="threshold"):
                bon.recover_sum({}, pubs, {}, tag, threshold=bad_t)
        with pytest.raises(ValueError, match="threshold"):
            bon.make_recovery_shares(
                secrets_[0], 0, pubs, tag, threshold=n + 1
            )

    def test_honest_station_refuses_to_reveal_for_itself_when_dropped(self):
        n, tag = 3, "t"
        secrets_, pubs = _setup(n, tag)
        with pytest.raises(ValueError, match="dropped station"):
            bon.reveal_for_recovery(
                secrets_[0], 0, pubs, {}, survivors=[1, 2], tag=tag
            )

    def test_tampered_share_blob_detected(self):
        n, tag = 3, "t"
        secrets_, pubs = _setup(n, tag)
        blobs = bon.make_recovery_shares(secrets_[0], 0, pubs, tag)
        bad = bytearray(bytes.fromhex(blobs[1]))
        bad[0] ^= 1
        with pytest.raises(ValueError, match="failed authentication"):
            bon.reveal_for_recovery(
                secrets_[1], 1, pubs, {0: bytes(bad).hex()},
                survivors=[0, 1, 2], tag=tag,
            )

    def test_upload_still_masked(self):
        """A double-masked upload is not the quantized plaintext."""

        n, tag, scale = 3, "t", 2.0**12
        secrets_, pubs = _setup(n, tag)
        v = np.asarray([1.0, -2.0, 3.0], np.float32)
        up = bon.mask_update_bonawitz(secrets_[0], 0, pubs, v, scale, tag)
        assert not np.array_equal(up, native.quantize(v, scale))
        # and differs from the single-mask DH upload (the self mask is real)
        up_dh = dh.mask_update_dh(secrets_[0], 0, pubs, v, scale, tag)
        assert not np.array_equal(up, up_dh)


# ------------------------------------------------------ cross-package
def _secrets(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


class TestDHAgainstJax:
    """The same secrets, tag and values through both packages."""

    def test_adverts_and_pair_seeds_bit_for_bit(self):
        tag = "agg-x1"
        secrets_ = _secrets(4, 1)
        for s in secrets_:
            assert dh.keypair_ikm(s, tag) == JDH.keypair_ikm(s, tag)
        pubs = {i: dh.derive_keypair(s, tag)[1]
                for i, s in enumerate(secrets_)}
        assert pubs == {i: JDH.derive_keypair(s, tag)[1]
                        for i, s in enumerate(secrets_)}
        for i in range(4):
            t_priv, _ = dh.derive_keypair(secrets_[i], tag)
            j_priv, _ = JDH.derive_keypair(secrets_[i], tag)
            for j in range(4):
                if j != i:
                    assert (dh.pairwise_seed(t_priv, pubs[j], i, j, tag)
                            == JDH.pairwise_seed(j_priv, pubs[j], i, j, tag))
        assert (dh.advert_message(2, pubs[2], tag)
                == JDH.advert_message(2, pubs[2], tag))

    @pytest.mark.parametrize("n,dim", [(2, 3), (5, 257)])
    def test_masked_uploads_bit_for_bit(self, n, dim):
        tag, scale = "agg-x2", 2.0**14
        rng = np.random.default_rng(n * dim)
        secrets_ = _secrets(n, n)
        pubs = {i: dh.derive_keypair(s, tag)[1]
                for i, s in enumerate(secrets_)}
        vals = rng.normal(0, 3, (n, dim)).astype(np.float32)
        ours = np.stack([dh.mask_update_dh(secrets_[s], s, pubs, vals[s],
                                           scale, tag) for s in range(n)])
        theirs = np.stack([JDH.mask_update_dh(secrets_[s], s, pubs, vals[s],
                                              scale, tag) for s in range(n)])
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(dh.unmask_sum_dh(ours, scale),
                                      JDH.unmask_sum_dh(theirs, scale))

    def test_signatures_verify_across_packages(self):
        from vantage6_tpu_torch.common.encryption import RSACryptor

        JRSA = importlib.import_module(
            "vantage6_tpu.common.encryption").RSACryptor
        tag = "agg-x3"
        secrets_ = _secrets(2, 3)
        pubs = {i: dh.derive_keypair(s, tag)[1]
                for i, s in enumerate(secrets_)}
        cryptors = [RSACryptor(RSACryptor.create_new_rsa_key()),
                    JRSA(JRSA.create_new_rsa_key())]
        idents = {i: c.public_key_str for i, c in enumerate(cryptors)}
        # station 0 signs with the port, station 1 with the JAX package
        sigs = {0: dh.sign_advert(cryptors[0], 0, pubs[0], tag),
                1: JDH.sign_advert(cryptors[1], 1, pubs[1], tag)}
        dh.verify_adverts(pubs, idents, sigs, tag)
        JDH.verify_adverts(pubs, idents, sigs, tag)
        v = np.ones(3, np.float32)
        np.testing.assert_array_equal(
            dh.mask_update_dh(secrets_[0], 0, pubs, v, tag=tag,
                              identities=idents, signatures=sigs),
            JDH.mask_update_dh(secrets_[0], 0, pubs, v, tag=tag,
                               identities=idents, signatures=sigs))
        swapped = {0: sigs[1], 1: sigs[0]}
        for mod in (dh, JDH):
            with pytest.raises(ValueError, match="INVALID"):
                mod.verify_adverts(pubs, idents, swapped, tag)


def _protocol(mod, n, dim, dropped, tag, scale, seed):
    """The four Bonawitz rounds through one package; every intermediate
    returned for comparison."""
    rng = np.random.default_rng(seed)
    secrets_ = _secrets(n, seed)
    pubs = {i: mod.derive_keypair(s, tag)[1]
            for i, s in enumerate(secrets_)}
    vectors = rng.normal(0, 2, (n, dim)).astype(np.float32)
    t = mod.default_threshold(n)
    blobs = {s: mod.make_recovery_shares(secrets_[s], s, pubs, tag,
                                         threshold=t) for s in range(n)}
    survivors = [s for s in range(n) if s not in dropped]
    uploads = {s: mod.mask_update_bonawitz(secrets_[s], s, pubs,
                                           vectors[s], scale, tag)
               for s in survivors}
    reveals = {s: mod.reveal_for_recovery(
        secrets_[s], s, pubs, {o: blobs[o][s] for o in range(n) if o != s},
        survivors=survivors, tag=tag, threshold=t) for s in survivors}
    out = mod.recover_sum(uploads, pubs, reveals, tag, threshold=t,
                          scale=scale)
    return dict(pubs=pubs, blobs=blobs, uploads=uploads, reveals=reveals,
                out=out, want=vectors[survivors].sum(0))


class TestBonawitzAgainstJax:
    """Each package's Bonawitz module (which imports ``derive_keypair``
    from its DH module) through the same rounds."""

    @pytest.mark.parametrize("n,dim,dropped", [
        (4, 33, set()), (4, 17, {3}), (5, 9, {1, 4}), (7, 64, {0, 6})])
    def test_protocol_bit_for_bit(self, n, dim, dropped):
        tag, scale = "agg-bz", 2.0**12
        ours = _protocol(bon, n, dim, dropped, tag, scale, seed=n + dim)
        theirs = _protocol(JBON, n, dim, dropped, tag, scale, seed=n + dim)
        assert ours["pubs"] == theirs["pubs"]
        assert ours["blobs"] == theirs["blobs"]
        assert ours["uploads"].keys() == theirs["uploads"].keys()
        for s in ours["uploads"]:
            np.testing.assert_array_equal(ours["uploads"][s],
                                          theirs["uploads"][s])
        assert ours["reveals"] == theirs["reveals"]
        np.testing.assert_array_equal(ours["out"], theirs["out"])
        np.testing.assert_allclose(ours["out"], ours["want"],
                                   atol=n / scale)

    def test_recover_sum_across_packages(self):
        """The port's aggregator recovers the JAX stations' uploads and
        reveals (one dropout), and the other way round."""
        tag, scale = "agg-bz2", 2.0**12
        theirs = _protocol(JBON, 5, 11, {2}, tag, scale, seed=9)
        ours = _protocol(bon, 5, 11, {2}, tag, scale, seed=9)
        t = bon.default_threshold(5)
        np.testing.assert_array_equal(
            bon.recover_sum(theirs["uploads"], theirs["pubs"],
                            theirs["reveals"], tag, threshold=t, scale=scale),
            JBON.recover_sum(ours["uploads"], ours["pubs"], ours["reveals"],
                             tag, threshold=t, scale=scale))


# ------------------- a dropout through the port's Federation and faults
@pytest.mark.parametrize("workers", [0, 3])
def test_bonawitz_dropout_through_fault(workers):
    """A station whose upload is swallowed by the ``drop`` fault is named
    in ``dropped`` and the average is the survivors' (the central finds
    the dropout through ``wait_for_results``' timeout or the owed run)."""
    pytest.importorskip("cryptography")
    rng = np.random.default_rng(17)
    cols = [{"age": rng.normal(40 + i, 5, 30)} for i in range(4)]
    fed = federation_from_datasets(
        cols, {"sa": secure_average}, executor_workers=workers, device="cpu")
    # station 2's third run (advertise, share, then upload) is dropped
    FAULTS.configure("drop:station=2,after=2,limit=1")
    try:
        task = fed.create_task("sa", {
            "method": "central_secure_average_bonawitz",
            "kwargs": {"column": "age", "max_abs": 2.0**16,
                       "upload_timeout": 0.5, "poll_interval": 0.02}},
            organizations=[0])
        out = fed.wait_for_results(task.id)[0]
    finally:
        FAULTS.clear()
        fed.close()
    survivors = np.concatenate([cols[i]["age"] for i in (0, 1, 3)])
    assert out["dropped"] == [2] and out["n_parties"] == 4
    assert out["count"] == survivors.size
    assert abs(out["average"] - survivors.mean()) < 1e-3
