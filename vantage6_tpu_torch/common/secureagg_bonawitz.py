"""Dropout-recoverable secure aggregation — the full Bonawitz construction.

Upgrades `common.secureagg_dh` (per-pair X25519 masks, honest-but-curious
aggregator) with the two missing properties of Bonawitz et al., CCS'17
("Practical Secure Aggregation for Privacy-Preserving Machine Learning"),
the protocol class SURVEY.md:158 cites for this subsystem:

1. **Dropout recovery.** Every station Shamir-shares (common.shamir) the
   seed of its per-aggregation X25519 key among its peers. If a station
   advertises but never uploads, any `threshold` surviving peers can hand
   the aggregator the shares of THAT station's seed; the aggregator
   reconstructs its pairwise seeds and strips the orphaned masks, so the
   survivor-set sum completes instead of the round being garbage.
2. **The double mask.** Each station also adds a personal self-mask `b_i`
   (its seed equally Shamir-shared). For *survivors*, peers reveal the
   `b_i` shares (so self-masks can be removed from the total); for
   *dropped* stations they reveal the key-seed shares. A peer never
   reveals both for the same station — otherwise a lying aggregator could
   claim "station i dropped" AFTER receiving i's upload, strip i's
   pairwise masks, and read its plaintext. With the double mask, stripping
   the pairwise masks of a station that actually uploaded still leaves its
   self-mask in place.

Transport: the protocol is three task rounds through the normal control
plane (advertise [+signature — secureagg_dh.sign_advert], share, upload),
plus one reveal round among survivors on dropout. Share blobs relayed by
the server are encrypted to their recipient with a key only that pair can
derive (X25519 -> HMAC -> ChaCha20, authenticated with HMAC-SHA256/16) —
the relay sees nothing, exactly as it sees nothing of the masks.

All derivations are deterministic from (station_secret, tag): stateless
task rounds re-derive identical keys, shares and masks, like the rest of
the DH path. The per-aggregation `tag` domain-separates everything.

The port's copy of ``vantage6_tpu/common/secureagg_bonawitz.py``: for the
same inputs (dropouts included) its share blobs, double-masked uploads,
reveals and ``recover_sum`` are the JAX package's, bit for bit.
"""
from __future__ import annotations

import hashlib
import hmac
from typing import Iterable, Mapping

import numpy as np

from vantage6_tpu_torch import native
from vantage6_tpu_torch.common import shamir
from vantage6_tpu_torch.common.secureagg_dh import (
    derive_keypair,
    keypair_from_ikm,
    keypair_ikm,
    mask_update_dh,
    pairwise_seed,
    _tag_bytes,
)

#: nonce peer-index for a station's SELF mask stream (never a real station)
_SELF = 0xFFFFFFFF
_MAC_LEN = 16


def default_threshold(n: int) -> int:
    """Majority threshold: tolerates up to n - (n//2 + 1) colluding-or-lost
    parties, the standard Bonawitz operating point."""
    return n // 2 + 1


def _check_threshold(n: int, t: int) -> int:
    """The 'never reveal both' invariant only holds for t > n/2: two
    disjoint groups of >= t stations cannot then exist, so a lying
    aggregator cannot collect t self-mask shares from one group AND t
    key-seed shares from another for the same uploaded station. Reject any
    weaker threshold at every share/reveal/recover entry point."""
    if not n // 2 < t <= n:
        raise ValueError(
            f"threshold {t} violates n//2 < t <= n (n={n}): a minority "
            "threshold lets a lying aggregator unmask an honest upload"
        )
    return t


def selfmask_seed(station_secret: bytes, tag) -> bytes:
    if len(station_secret) < 16:
        raise ValueError("station secret must be >= 16 bytes")
    return hmac.new(
        station_secret, b"v6t-selfmask-v1:" + _tag_bytes(tag), hashlib.sha256
    ).digest()


def _coeff_stream(station_secret: bytes, tag, purpose: bytes, n: int) -> bytes:
    """Deterministic uniform bytes for Shamir coefficients (keyed PRF)."""
    key = hmac.new(
        station_secret,
        b"v6t-shamir-coeff-v1:" + purpose + b":" + _tag_bytes(tag),
        hashlib.sha256,
    ).digest()
    words = native.chacha20_stream(key, bytes(12), (n + 3) // 4)
    return words.astype("<u4").tobytes()[:n]


def _wrap_key(pair_seed: bytes) -> bytes:
    return hmac.new(
        pair_seed, b"v6t-share-wrap-v1", hashlib.sha256
    ).digest()


def _xor_stream(key: bytes, nonce: bytes, data: bytes) -> bytes:
    words = native.chacha20_stream(key, nonce, (len(data) + 3) // 4)
    ks = words.astype("<u4").tobytes()[: len(data)]
    return bytes(a ^ b for a, b in zip(data, ks))


def _seal(pair_seed: bytes, i: int, j: int, data: bytes) -> bytes:
    """Encrypt-then-MAC `data` from station i to station j."""
    key = _wrap_key(pair_seed)
    ct = _xor_stream(key, native.pair_nonce(i, j), data)
    mac = hmac.new(key, b"%d:%d:" % (i, j) + ct, hashlib.sha256).digest()
    return ct + mac[:_MAC_LEN]


def _open(pair_seed: bytes, i: int, j: int, blob: bytes) -> bytes:
    key = _wrap_key(pair_seed)
    ct, mac = blob[:-_MAC_LEN], blob[-_MAC_LEN:]
    want = hmac.new(key, b"%d:%d:" % (i, j) + ct, hashlib.sha256).digest()
    if not hmac.compare_digest(mac, want[:_MAC_LEN]):
        raise ValueError(f"share blob from station {i} failed authentication")
    return _xor_stream(key, native.pair_nonce(i, j), ct)


# ------------------------------------------------------------------ station
def make_recovery_shares(
    station_secret: bytes,
    station: int,
    pubkeys: Mapping[int, str],
    tag,
    threshold: int | None = None,
) -> dict[int, str]:
    """Round 2 (after adverts): this station's encrypted share blobs.

    Returns {peer index -> hex blob}; each blob holds the peer's Shamir
    share of BOTH this station's X25519 key seed and its self-mask seed,
    sealed to that peer. Relayed through the server like any task result.
    """
    pubs = dict(pubkeys)
    n = len(pubs)
    t = _check_threshold(
        n, default_threshold(n) if threshold is None else threshold
    )
    priv, _ = derive_keypair(station_secret, tag)
    ikm = keypair_ikm(station_secret, tag)
    b_seed = selfmask_seed(station_secret, tag)
    order = sorted(pubs)  # share x-coordinate = 1 + rank in station order
    coeff_len = (t - 1) * 32
    priv_shares = shamir.share_secret(
        ikm, n, t, _coeff_stream(station_secret, tag, b"priv", coeff_len or 1)
    )
    b_shares = shamir.share_secret(
        b_seed, n, t, _coeff_stream(station_secret, tag, b"self", coeff_len or 1)
    )
    out: dict[int, str] = {}
    for rank, peer in enumerate(order):
        if peer == station:
            continue
        seed = pairwise_seed(priv, pubs[peer], station, peer, tag)
        blob = _seal(
            seed, station, peer, priv_shares[rank] + b_shares[rank]
        )
        out[peer] = blob.hex()
    return out


def mask_update_bonawitz(
    station_secret: bytes,
    station: int,
    pubkeys: Mapping[int, str],
    values: np.ndarray,
    scale: float = 2.0**16,
    tag=b"",
    identities: Mapping[int, str] | None = None,
    signatures: Mapping[int, str] | None = None,
) -> np.ndarray:
    """Round 3: the double-masked upload = quantize(values) + b_i stream
    + sum of signed pairwise streams (all mod 2^32)."""
    masked = mask_update_dh(
        station_secret, station, pubkeys, values, scale, tag,
        identities=identities, signatures=signatures,
    )
    b_seed = selfmask_seed(station_secret, tag)
    stream = native.chacha20_stream(
        b_seed, native.pair_nonce(station, _SELF), masked.size
    )
    with np.errstate(over="ignore"):
        out = masked.reshape(-1).astype(np.uint32) + stream
    return out.astype(np.int32).reshape(masked.shape)


def reveal_for_recovery(
    station_secret: bytes,
    station: int,
    pubkeys: Mapping[int, str],
    blobs_from: Mapping[int, str],
    survivors: Iterable[int],
    tag,
    threshold: int | None = None,
) -> dict[int, tuple[str, str]]:
    """Round 4 (run by each surviving station): open the share blobs peers
    sent me and reveal, per origin station, EITHER its self-mask share
    (origin survived — lets the aggregator strip self-masks) OR its key-seed
    share (origin dropped — lets the aggregator strip orphaned pairwise
    masks). Never both: that invariant is what stops a lying aggregator
    from unmasking an upload it already holds.

    Returns {origin -> ("b" | "priv", share hex)}.
    """
    pubs = dict(pubkeys)
    live = set(survivors)
    if station not in live:
        raise ValueError("a dropped station cannot run the reveal round")
    priv, _ = derive_keypair(station_secret, tag)
    out: dict[int, tuple[str, str]] = {}
    for origin, blob_hex in blobs_from.items():
        if origin == station:
            continue
        seed = pairwise_seed(priv, pubs[origin], origin, station, tag)
        data = _open(seed, origin, station, bytes.fromhex(blob_hex))
        priv_share, b_share = data[:32], data[32:64]
        if origin in live:
            out[origin] = ("b", b_share.hex())
        else:
            out[origin] = ("priv", priv_share.hex())
    # also reveal MY OWN self-mask share (re-derived — my blob to myself was
    # never sent): without it a survivor's b has only n_surv - 1 shares and
    # majority thresholds become unrecoverable after a single dropout. A
    # survivor revealing its own b-share is safe — b_me is *meant* to be
    # stripped from the total once my upload is in.
    n = len(pubs)
    t = _check_threshold(
        n, default_threshold(n) if threshold is None else threshold
    )
    order = sorted(pubs)
    my_rank = order.index(station)
    coeff_len = (t - 1) * 32
    own_b_shares = shamir.share_secret(
        selfmask_seed(station_secret, tag), n, t,
        _coeff_stream(station_secret, tag, b"self", coeff_len or 1),
    )
    out[station] = ("b", own_b_shares[my_rank].hex())
    return out


# --------------------------------------------------------------- aggregator
def recover_sum(
    uploads: Mapping[int, np.ndarray],
    pubkeys: Mapping[int, str],
    reveals: Mapping[int, Mapping[int, tuple[str, str]]],
    tag,
    threshold: int | None = None,
    scale: float = 2.0**16,
) -> np.ndarray:
    """The aggregator's recovery: exact sum of the SURVIVORS' values.

    uploads:  {station -> double-masked int32 vector} (survivor set)
    reveals:  {revealing station -> its reveal_for_recovery output}
    Works with zero dropouts too (then it only strips self-masks), so this
    is THE unmasking entry point for the Bonawitz path.
    """
    pubs = dict(pubkeys)
    n = len(pubs)
    t = _check_threshold(
        n, default_threshold(n) if threshold is None else threshold
    )
    order = sorted(pubs)
    rank = {s: r for r, s in enumerate(order)}
    survivors = sorted(uploads)
    dropped = sorted(set(pubs) - set(uploads))
    if len(survivors) < t:
        raise ValueError(
            f"only {len(survivors)} survivors < threshold {t}: unrecoverable"
        )

    # collect shares per origin, enforcing the either/or invariant
    b_shares: dict[int, dict[int, bytes]] = {s: {} for s in survivors}
    priv_shares: dict[int, dict[int, bytes]] = {d: {} for d in dropped}
    for revealer, per_origin in reveals.items():
        for origin, (kind, share_hex) in per_origin.items():
            share = bytes.fromhex(share_hex)
            if kind == "b":
                if origin in dropped:
                    continue  # useless: dropped stations need priv shares
                b_shares[origin][rank[revealer]] = share
            elif kind == "priv":
                if origin in uploads:
                    raise ValueError(
                        f"station {revealer} revealed the KEY share of "
                        f"surviving station {origin} — protocol violation "
                        "(would let the aggregator unmask an upload); abort"
                    )
                priv_shares[origin][rank[revealer]] = share
            else:
                raise ValueError(f"unknown reveal kind {kind!r}")

    stacked = np.stack([np.asarray(uploads[s]) for s in survivors])
    total = native.sum_wrapping(stacked)
    size = total.size
    flat = total.reshape(-1).astype(np.uint32)

    with np.errstate(over="ignore"):
        # 1) strip survivors' self-masks (reconstructed b_i)
        for s in survivors:
            seed = shamir.reconstruct_secret(b_shares[s], t)
            flat = flat - native.chacha20_stream(
                seed, native.pair_nonce(s, _SELF), size
            )
        # 2) strip dropped stations' orphaned pairwise masks: survivor u
        #    added sign(u, d) * stream_{u,d} that d never cancelled
        for d in dropped:
            ikm = shamir.reconstruct_secret(priv_shares[d], t)
            priv_d, pub_d_hex = keypair_from_ikm(ikm)
            if pub_d_hex != pubs[d]:
                raise ValueError(
                    f"reconstructed key for dropped station {d} does not "
                    "match its advert — bad shares or tampered advert"
                )
            for u in survivors:
                lo, hi = min(u, d), max(u, d)
                seed = pairwise_seed(priv_d, pubs[u], lo, hi, tag)
                stream = native.chacha20_stream(
                    seed, native.pair_nonce(lo, hi), size
                )
                # u contributed +stream if u == lo else -stream; remove it
                flat = flat - stream if u == lo else flat + stream
    return native.dequantize(
        flat.astype(np.int32).reshape(total.shape), scale
    )
