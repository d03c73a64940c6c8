"""Secure federated column average — host-path secure aggregation.

Parity: the reference's secure-sum algorithm repos (Paillier-based partial
sums; SURVEY.md §2.3 "secure aggregation"). The cross-host path uses
pairwise additive masking with native ChaCha20 kernels
(vantage6_tpu_torch.native): each station uploads a masked fixed-point
vector and the central step's wrapping sum cancels every mask. The on-card
equivalent is fed.collectives.secure_sum.

THREAT MODEL — read before relying on this (same honesty note as
fed.collectives and docs/THREAT_MODEL.md): masks derive from ONE shared
seed, so the guarantee is scoped to observers who do NOT hold it — the
relaying server in an E2E-encrypted collaboration (the seed travels inside
the encrypted task payload), log/trace readers, and any party shown a
single masked upload. A party holding the seed (including the central
aggregator itself) CAN regenerate the masks and unmask individual uploads.
Defending against an untrusted aggregator requires per-pair Diffie-Hellman
mask secrets (Bonawitz et al.) so that no single party knows all masks —
that is the `central_secure_average_dh` variant below; the full Bonawitz
double-mask protocol with dropout recovery is `central_secure_average_
bonawitz` (four task rounds; survives a station dying mid-protocol).
Provision the seed out-of-band (station configs), never through an
unencrypted task payload.

The port's copy of ``vantage6_tpu/workloads/secure_average.py``. The
partials read a station's column through ``workloads/_columns.py`` (a dict
of arrays or a DataFrame) with pandas' semantics: NaN is skipped by both
the sum and the count. Called with the same tag, a partial's upload is the
JAX package's, bit for bit; the centrals draw a fresh tag each time.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from vantage6_tpu_torch.algorithm.decorators import algorithm_client, data
from vantage6_tpu_torch.workloads._columns import column as _column


def _sum_count(df: Any, column: str, max_abs: float) -> np.ndarray:
    """``[sum, count]`` of one column as pandas' ``Series.sum()`` and
    ``Series.count()`` give them (NaN skipped by both; a float sum is the
    column's sum with NaN read as 0, as pandas computes it), in float32
    and clipped to ±max_abs."""
    v = _column(df, column)
    if v.dtype.kind == "f":
        nan = np.isnan(v)
        total, count = np.where(nan, 0, v).sum(), v.size - int(nan.sum())
    else:
        total, count = v.sum(), v.size
    return np.clip(
        np.asarray([total, float(count)], np.float32), -max_abs, max_abs
    )


@data(1)
def partial_secure_average(
    df: Any,
    column: str,
    seed_hex: str,
    party_index: int,
    n_parties: int,
    scale: float,
    max_abs: float,
    agg_tag: str = "",
) -> dict[str, Any]:
    """Upload = masked [sum, count]; plaintext never leaves the station.

    Values are clipped to ±max_abs — the range contract every party shares
    so the fixed-point aggregate can NEVER wrap (see central's scale
    derivation). A clipped sum is a bias, not corruption; widen max_abs if
    your sums exceed it.
    """
    from vantage6_tpu_torch import native

    vec = _sum_count(df, column, max_abs)
    masked = native.mask_update(
        bytes.fromhex(seed_hex), party_index, n_parties, vec, scale,
        tag=agg_tag,
    )
    return {"masked": masked, "party_index": party_index}


@algorithm_client
def central_secure_average(
    client: Any,
    column: str,
    seed_hex: str,
    organizations: list[int] | None = None,
    max_abs: float = 2.0**24,
) -> dict[str, Any]:
    """Fan out masked partials; the wrapping sum cancels the masks.

    Privacy is against observers WITHOUT the seed (see the module threat
    model) — this central function holds the seed and could unmask; the
    protection is for the transport/relay path.

    ``max_abs`` bounds every party's |sum| and |count| (values are clipped
    at the stations); the fixed-point scale is derived as
    ``2^30 / (n_parties * max_abs)`` so the n-party aggregate provably fits
    in int32 — no silent wrap-around. Precision of the result is 1/scale.
    """
    from vantage6_tpu_torch import native

    import secrets

    orgs = organizations or [o["id"] for o in client.organization.list()]
    n = len(orgs)
    if n < 2:
        raise ValueError(
            "secure aggregation needs >= 2 parties (a single masked upload "
            "would be trivially unmaskable by the seed holder)"
        )
    scale = 2.0**30 / (n * max_abs)
    # fresh per-aggregation tag: mask keystreams must never repeat across
    # aggregations under one provisioned seed (native.derive_mask_key) —
    # the tag is not secret, it only provides domain separation
    agg_tag = secrets.token_hex(16)
    # one subtask per org: each party must learn its own party_index.
    # wait=False: all parties mask CONCURRENTLY on the station executor
    # pool (create-all-then-collect), like real nodes would
    uploads = []
    subtasks = []
    for idx, org in enumerate(orgs):
        subtasks.append(
            client.task.create(
                input_={
                    "method": "partial_secure_average",
                    "kwargs": {
                        "column": column,
                        "seed_hex": seed_hex,
                        "party_index": idx,
                        "n_parties": n,
                        "scale": scale,
                        "max_abs": max_abs,
                        "agg_tag": agg_tag,
                    },
                },
                organizations=[org],
                name=f"secure_partial_{idx}",
                wait=False,
            )
        )
    for sub in subtasks:
        result = client.wait_for_results(task_id=sub["id"])[0]
        uploads.append(np.asarray(result["masked"], np.int32))
    total = native.unmask_sum(np.stack(uploads), scale)
    g_sum, g_count = float(total[0]), float(total[1])
    return {
        "average": g_sum / g_count if g_count else float("nan"),
        "count": int(round(g_count)),
    }


# --------------------------------------------------------------------------
# Untrusted-aggregator variant: per-pair X25519 DH mask agreement
# (common.secureagg_dh; Bonawitz et al. CCS'17 key provisioning). Two task
# rounds: stations advertise per-aggregation public keys through the server,
# then upload masked vectors whose pairwise masks only the two endpoint
# stations can compute — the aggregator, holding every pubkey and every
# upload, cannot unmask anyone.
# --------------------------------------------------------------------------


def partial_advertise_mask_key(party_index: int, agg_tag: str) -> dict[str, Any]:
    """Round 1: publish this station's per-aggregation X25519 public key.

    The keypair derives deterministically from the station-LOCAL secret and
    the tag, so round 2 re-derives the same private key with no state.
    When the runtime provisions an org RSA identity, the advert is signed
    (RSA-PSS over the canonical (party, pubkey, tag) message) so verifying
    peers detect a key-substituting relay."""
    from vantage6_tpu_torch.common import secureagg_dh as dh

    _, pub_hex = dh.derive_keypair(dh.get_station_secret(), agg_tag)
    out = {"party_index": party_index, "pubkey": pub_hex}
    identity = dh.get_identity()
    if identity is not None:
        out["signature"] = dh.sign_advert(
            identity, party_index, pub_hex, agg_tag
        )
    return out


@data(1)
def partial_secure_average_dh(
    df: Any,
    column: str,
    party_index: int,
    pubkeys: list[list[Any]],
    scale: float,
    max_abs: float,
    agg_tag: str,
    org_ids: list[int] | None = None,
    signatures: list[list[Any]] | None = None,
) -> dict[str, Any]:
    """Round 2: upload = DH-masked [sum, count]; same clipping contract as
    the single-seed variant. ``pubkeys`` is [[party_index, pub_hex], ...]
    for ALL parties (wire-safe pair list; JSON would stringify int keys).

    Advert authentication (fail closed): when this station's runtime
    provisions an identity-pubkey roster (org_identities), the relayed
    adverts MUST verify against it — ``org_ids`` maps party_index to the
    organization/station id the roster is keyed by, and ``signatures`` is
    [[party_index, sig_hex], ...]. A relay substituting pubkeys (or
    shrinking the roster) aborts the round here instead of silently
    unmasking this station's upload.
    """
    from vantage6_tpu_torch.common import secureagg_dh as dh

    pub_map = {int(i): p for i, p in pubkeys}
    sig_map = {int(i): s for i, s in (signatures or [])}
    identities = _roster_identities(agg_tag, pub_map, org_ids, signatures)
    vec = _sum_count(df, column, max_abs)
    masked = dh.mask_update_dh(
        dh.get_station_secret(),
        party_index,
        pub_map,
        vec,
        scale,
        tag=agg_tag,
        identities=identities,
        signatures=sig_map,
    )
    return {"masked": masked, "party_index": party_index}


def _roster_identities(
    agg_tag: str,
    pub_map: dict[int, str],
    org_ids: list[int] | None,
    signatures: list[list[Any]] | None,
    verify_now: bool = False,
) -> dict[int, str] | None:
    """Shared fail-closed roster resolution for the DH/Bonawitz partials.

    ``org_ids`` arrives THROUGH the relay being defended against, so it
    cannot be trusted to pick the participant subset: a relay could shrink
    it to {victim} (every remaining advert validly signed) and the victim
    would upload with zero pairwise masks. With a locally provisioned
    identity registry the roster must therefore equal the registry exactly
    — the out-of-band trust root. Subset aggregations under verification
    need a roster signed by the initiating user (not implemented; run the
    full collaboration or provision a per-study registry).

    Returns the {party_index -> identity pubkey} map for signature
    verification, or None when no registry is provisioned.
    ``verify_now=True`` additionally verifies every advert immediately
    (rounds that consume pubkeys without masking, e.g. Bonawitz share
    sealing, have no later verification point).
    """
    from vantage6_tpu_torch.common import secureagg_dh as dh

    registry = dh.get_org_identities()
    if registry is None:
        return None
    if org_ids is None:
        raise ValueError(
            "identity roster provisioned but task carries no org_ids — "
            "cannot verify adverts; refusing to proceed"
        )
    if {int(o) for o in org_ids} != set(registry):
        raise ValueError(
            "aggregation roster does not match the provisioned identity "
            f"registry (task: {sorted(int(o) for o in org_ids)}, "
            f"registry: {sorted(registry)}) — refusing a relay-chosen "
            "participant subset"
        )
    identities = {idx: registry[int(org)] for idx, org in enumerate(org_ids)}
    if verify_now:
        dh.verify_adverts(
            pub_map,
            identities,
            {int(i): s for i, s in (signatures or [])},
            agg_tag,
        )
    return identities


@algorithm_client
def central_secure_average_dh(
    client: Any,
    column: str,
    organizations: list[int] | None = None,
    max_abs: float = 2.0**24,
) -> dict[str, Any]:
    """Secure average with NO shared seed: this central function (and an
    honest-but-curious server relaying everything) sees only public keys
    and masked uploads and cannot reconstruct an individual station's
    [sum, count]. When the stations' runtimes provision org identity keys,
    adverts are signed and every station verifies the full roster before
    uploading — a key-substituting (active MitM) relay makes the round fail
    closed (tests/test_secureagg_dh.py::TestSignedAdverts; THREAT_MODEL.md).

    No dropout recovery: every advertiser must upload (use
    central_secure_average_bonawitz for the recovering variant) — a missing
    upload leaves masks uncancelled and the round is retried.
    """
    import secrets

    from vantage6_tpu_torch.common import secureagg_dh as dh

    orgs = organizations or [o["id"] for o in client.organization.list()]
    n = len(orgs)
    if n < 2:
        raise ValueError(
            "secure aggregation needs >= 2 parties (a single masked upload "
            "has no pairwise masks at all)"
        )
    scale = 2.0**30 / (n * max_abs)
    agg_tag = secrets.token_hex(16)

    # round 1: collect per-aggregation public keys (parallel fan-out)
    adverts = []
    for idx, org in enumerate(orgs):
        adverts.append(
            client.task.create(
                input_={
                    "method": "partial_advertise_mask_key",
                    "kwargs": {"party_index": idx, "agg_tag": agg_tag},
                },
                organizations=[org],
                name=f"dh_advertise_{idx}",
                wait=False,
            )
        )
    pubkeys: list[list[Any]] = []
    signatures: list[list[Any]] = []
    for sub in adverts:
        r = client.wait_for_results(task_id=sub["id"])[0]
        pubkeys.append([int(r["party_index"]), r["pubkey"]])
        if r.get("signature"):
            signatures.append([int(r["party_index"]), r["signature"]])

    # round 2: masked uploads under the advertised keys (signatures and the
    # party->org mapping relayed so each station can verify the roster
    # against its LOCAL identity registry)
    subtasks = []
    for idx, org in enumerate(orgs):
        subtasks.append(
            client.task.create(
                input_={
                    "method": "partial_secure_average_dh",
                    "kwargs": {
                        "column": column,
                        "party_index": idx,
                        "pubkeys": pubkeys,
                        "scale": scale,
                        "max_abs": max_abs,
                        "agg_tag": agg_tag,
                        "org_ids": [int(o) for o in orgs],
                        "signatures": signatures,
                    },
                },
                organizations=[org],
                name=f"dh_secure_partial_{idx}",
                wait=False,
            )
        )
    uploads = []
    for sub in subtasks:
        result = client.wait_for_results(task_id=sub["id"])[0]
        uploads.append(np.asarray(result["masked"], np.int32))
    total = dh.unmask_sum_dh(np.stack(uploads), scale)
    g_sum, g_count = float(total[0]), float(total[1])
    return {
        "average": g_sum / g_count if g_count else float("nan"),
        "count": int(round(g_count)),
    }


# --------------------------------------------------------------------------
# Dropout-recoverable variant: the FULL Bonawitz double-mask construction
# (common.secureagg_bonawitz) driven as real task rounds through the normal
# control plane: advertise -> share -> upload -> reveal. A station that
# dies between sharing and uploading no longer spoils the aggregate: any
# `threshold` survivors hand the aggregator the dropped station's key-seed
# shares and the orphaned pairwise masks are stripped, while the double
# mask keeps a LYING aggregator from unmasking an upload it already holds
# (reference protocol: SURVEY.md:158; library tests:
# tests/test_secureagg_bonawitz.py).
#
# Round contract: every station must COMPLETE the share round — a failure
# there aborts the aggregation (shares are Shamir-split over the full
# roster, so excluding a station post-hoc would desynchronize share
# x-coordinates). Dropout tolerance begins once shares are distributed,
# which is exactly the Bonawitz round structure.
# --------------------------------------------------------------------------


def partial_bonawitz_shares(
    party_index: int,
    pubkeys: list[list[Any]],
    agg_tag: str,
    threshold: int,
    org_ids: list[int] | None = None,
    signatures: list[list[Any]] | None = None,
) -> dict[str, Any]:
    """Round 2: Shamir-share this station's key seed AND self-mask seed
    among its peers, each share sealed to its recipient (the relay sees
    ciphertext). Adverts are verified IMMEDIATELY when an identity roster
    is provisioned — this round seals secrets to the advertised keys, so a
    substituted advert must abort here, not at upload."""
    from vantage6_tpu_torch.common import secureagg_bonawitz as bz
    from vantage6_tpu_torch.common import secureagg_dh as dh

    pub_map = {int(i): p for i, p in pubkeys}
    _roster_identities(agg_tag, pub_map, org_ids, signatures, verify_now=True)
    blobs = bz.make_recovery_shares(
        dh.get_station_secret(), party_index, pub_map, agg_tag, threshold
    )
    return {
        "party_index": party_index,
        "blobs": [[int(peer), blob] for peer, blob in sorted(blobs.items())],
    }


@data(1)
def partial_secure_average_bonawitz(
    df: Any,
    column: str,
    party_index: int,
    pubkeys: list[list[Any]],
    scale: float,
    max_abs: float,
    agg_tag: str,
    org_ids: list[int] | None = None,
    signatures: list[list[Any]] | None = None,
) -> dict[str, Any]:
    """Round 3: the DOUBLE-masked upload = quantized [sum, count] + this
    station's self-mask stream + signed pairwise streams. Same clipping
    contract as the other variants; same fail-closed advert verification
    as the DH upload."""
    from vantage6_tpu_torch.common import secureagg_bonawitz as bz
    from vantage6_tpu_torch.common import secureagg_dh as dh

    pub_map = {int(i): p for i, p in pubkeys}
    identities = _roster_identities(agg_tag, pub_map, org_ids, signatures)
    vec = _sum_count(df, column, max_abs)
    masked = bz.mask_update_bonawitz(
        dh.get_station_secret(),
        party_index,
        pub_map,
        vec,
        scale,
        tag=agg_tag,
        identities=identities,
        signatures={int(i): s for i, s in (signatures or [])},
    )
    return {"masked": masked, "party_index": party_index}


def partial_bonawitz_reveal(
    party_index: int,
    pubkeys: list[list[Any]],
    blobs_from: list[list[Any]],
    survivors: list[int],
    agg_tag: str,
    threshold: int,
    org_ids: list[int] | None = None,
    signatures: list[list[Any]] | None = None,
) -> dict[str, Any]:
    """Round 4 (survivors only): open the share blobs peers sealed to me
    and reveal, per origin, EITHER its self-mask share (origin uploaded)
    OR its key-seed share (origin dropped) — never both; the library
    enforces the invariant that protects uploads from a lying aggregator.
    Runs even with zero dropouts: self-masks must always be stripped."""
    from vantage6_tpu_torch.common import secureagg_bonawitz as bz
    from vantage6_tpu_torch.common import secureagg_dh as dh

    pub_map = {int(i): p for i, p in pubkeys}
    _roster_identities(agg_tag, pub_map, org_ids, signatures, verify_now=True)
    reveals = bz.reveal_for_recovery(
        dh.get_station_secret(),
        party_index,
        pub_map,
        {int(i): b for i, b in blobs_from},
        [int(s) for s in survivors],
        agg_tag,
        threshold,
    )
    return {
        "party_index": party_index,
        "reveals": [
            [int(origin), kind, share]
            for origin, (kind, share) in sorted(reveals.items())
        ],
    }


@algorithm_client
def central_secure_average_bonawitz(
    client: Any,
    column: str,
    organizations: list[int] | None = None,
    max_abs: float = 2.0**24,
    threshold: int | None = None,
    upload_timeout: float = 120.0,
    poll_interval: float = 1.0,
) -> dict[str, Any]:
    """Dropout-recoverable secure average: the Bonawitz protocol as four
    task rounds. Against an untrusted aggregator AND station failures:

    - this central (and the relaying server) sees only public keys,
      sealed share blobs, double-masked uploads and either/or reveals —
      never an individual station's [sum, count];
    - a station that dies after sharing but before uploading is declared
      dropped once ``upload_timeout`` passes; the survivors' reveal round
      lets the aggregate complete EXACTLY over the survivor set.

    Aborts (for retry) if any station fails the advertise or share round,
    or if fewer than ``threshold`` stations upload.
    """
    import secrets

    from vantage6_tpu_torch.common import secureagg_bonawitz as bz

    orgs = organizations or [o["id"] for o in client.organization.list()]
    n = len(orgs)
    if n < 2:
        raise ValueError(
            "secure aggregation needs >= 2 parties (and >= 3 for any "
            "dropout tolerance: majority threshold with n=2 is 2)"
        )
    t = bz.default_threshold(n) if threshold is None else threshold
    scale = 2.0**30 / (n * max_abs)
    agg_tag = secrets.token_hex(16)
    org_ids = [int(o) for o in orgs]

    def fanout(method: str, per_org_kwargs, targets, name: str):
        subs = []
        for idx, org in targets:
            subs.append(
                (
                    idx,
                    org,
                    client.task.create(
                        input_={
                            "method": method,
                            "kwargs": per_org_kwargs(idx),
                        },
                        organizations=[org],
                        name=f"{name}_{idx}",
                        # all parties run each protocol round concurrently;
                        # collect() polls afterwards (dropout discovery in
                        # round 3 relies on wait_for_results' timeout)
                        wait=False,
                    ),
                )
            )
        return subs

    def collect(subs, timeout=600.0):
        out = {}
        for idx, org, sub in subs:
            out[idx] = client.wait_for_results(
                task_id=sub["id"] if isinstance(sub, dict) else sub.id,
                interval=poll_interval,
                timeout=timeout,
            )[0]
        return out

    everyone = list(enumerate(orgs))

    # round 1: per-aggregation X25519 adverts (+ signatures when stations
    # provision identities)
    adverts = collect(
        fanout(
            "partial_advertise_mask_key",
            lambda idx: {"party_index": idx, "agg_tag": agg_tag},
            everyone,
            "bz_advertise",
        )
    )
    pubkeys = [[idx, adverts[idx]["pubkey"]] for idx, _ in everyone]
    signatures = [
        [idx, adverts[idx]["signature"]]
        for idx, _ in everyone
        if adverts[idx].get("signature")
    ]

    # round 2: encrypted recovery shares, relayed blind. ALL must complete.
    share_results = collect(
        fanout(
            "partial_bonawitz_shares",
            lambda idx: {
                "party_index": idx,
                "pubkeys": pubkeys,
                "agg_tag": agg_tag,
                "threshold": t,
                "org_ids": org_ids,
                "signatures": signatures,
            },
            everyone,
            "bz_share",
        )
    )
    # redistribute: blobs addressed TO station j, keyed by origin
    blobs_to: dict[int, list[list[Any]]] = {idx: [] for idx, _ in everyone}
    for origin, _ in everyone:
        for peer, blob in share_results[origin]["blobs"]:
            blobs_to[int(peer)].append([origin, blob])

    # round 3: double-masked uploads; a timeout/failure here is a DROPOUT,
    # not an abort — that is the point of the protocol
    upload_subs = fanout(
        "partial_secure_average_bonawitz",
        lambda idx: {
            "column": column,
            "party_index": idx,
            "pubkeys": pubkeys,
            "scale": scale,
            "max_abs": max_abs,
            "agg_tag": agg_tag,
            "org_ids": org_ids,
            "signatures": signatures,
        },
        everyone,
        "bz_upload",
    )
    uploads: dict[int, np.ndarray] = {}
    dropped_orgs: list[int] = []
    for idx, org, sub in upload_subs:
        try:
            r = client.wait_for_results(
                task_id=sub["id"] if isinstance(sub, dict) else sub.id,
                interval=poll_interval,
                timeout=upload_timeout,
            )[0]
            uploads[idx] = np.asarray(r["masked"], np.int32)
        except (TimeoutError, RuntimeError):
            dropped_orgs.append(int(org))
    survivors = sorted(uploads)
    if len(survivors) < t:
        raise RuntimeError(
            f"only {len(survivors)} uploads < threshold {t}: aggregation "
            "unrecoverable; retry with the surviving stations"
        )

    # round 4: survivors reveal (self-mask shares for survivors, key-seed
    # shares for the dropped) — required even with zero dropouts
    reveal_results = collect(
        fanout(
            "partial_bonawitz_reveal",
            lambda idx: {
                "party_index": idx,
                "pubkeys": pubkeys,
                "blobs_from": blobs_to[idx],
                "survivors": survivors,
                "agg_tag": agg_tag,
                "threshold": t,
                "org_ids": org_ids,
                "signatures": signatures,
            },
            [(idx, org) for idx, org in everyone if idx in uploads],
            "bz_reveal",
        )
    )
    reveals = {
        idx: {
            int(origin): (kind, share)
            for origin, kind, share in reveal_results[idx]["reveals"]
        }
        for idx in reveal_results
    }

    total = bz.recover_sum(
        uploads,
        {int(i): p for i, p in pubkeys},
        reveals,
        agg_tag,
        threshold=t,
        scale=scale,
    )
    g_sum, g_count = float(total[0]), float(total[1])
    return {
        "average": g_sum / g_count if g_count else float("nan"),
        "count": int(round(g_count)),
        "n_parties": n,
        "dropped": sorted(dropped_orgs),
    }
