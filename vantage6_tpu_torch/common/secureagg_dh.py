"""Per-pair X25519 mask agreement — untrusted-aggregator secure aggregation.

This is the Bonawitz-et-al. (CCS'17) key-provisioning upgrade the threat
model (docs/THREAT_MODEL.md) names for `native`'s additive
masking: instead of ONE shared seed (which whoever holds it — including the
central aggregator — can use to regenerate masks and unmask any upload),
every pair of stations agrees a pairwise secret via X25519 Diffie-Hellman.
Public keys travel through the server in the clear; the pairwise shared
secrets never exist anywhere but the two stations, so the server/aggregator,
holding ALL public material (every pubkey, every masked upload, the tag),
cannot reconstruct any individual update. Masks still cancel exactly in the
wrapping int32 sum, so the aggregate is exact.

Protocol (two task rounds through the normal control plane):
  1. advertise: each station derives an X25519 keypair from its LOCAL
     station secret + the aggregation tag and publishes the public key.
  2. upload: each station derives the pairwise seed for every peer
     (X25519(priv_i, pub_j) -> HMAC into a ChaCha20 key), masks its
     quantized vector with the native kernels, uploads.
  Aggregation is the plain wrapping sum (native.sum_wrapping) — the
  aggregator needs no keys at all.

Scope/honesty (same stance as the single-seed path's docs):

- against an HONEST-BUT-CURIOUS aggregator the masking alone suffices. An
  ACTIVE server could substitute its own keys in round 1 (classic DH MitM)
  and unmask; passing ``identities``/``signatures`` to ``mask_update_dh``
  closes this: adverts are RSA-PSS-signed with the organizations' identity
  keys (common.encryption.RSACryptor.sign_bytes) and verified before any
  pair seed is derived — see sign_advert/verify_adverts.
- dropout recovery for this module's two-round protocol lives in
  ``common.secureagg_bonawitz`` (Shamir-shared mask recovery, full
  Bonawitz); HERE, if a station that advertised fails to upload, its
  pairwise masks don't cancel and the round must be retried with the
  survivor set (the on-card path never drops stations mid-round by
  construction).

Derivations (all tagged, versioned):
  keypair:   priv_i = clamp(HMAC-SHA256(station_secret_i,
                                        "v6t-x25519-mask-v1:" || tag))
  pair seed: s_ij   = HMAC-SHA256(X25519(priv_i, pub_j),
                                  "v6t-pair-mask-v1:" || i || j || tag)
  mask:      ChaCha20(key=s_ij, nonce=[i, j, 0]), station min(i,j) adds +,
             max(i,j) adds − (cancellation identical to the native contract)

The per-aggregation `tag` gives the same domain separation as
native.derive_mask_key: fresh keypairs AND fresh pair seeds every round,
so uploads from different aggregations can never be differenced.

The port's copy of ``vantage6_tpu/common/secureagg_dh.py``: the same
derivations, so given equal station secrets, tag and pubkeys both packages
produce the same adverts, pair seeds and masked uploads, bit for bit. It
reads the run's secret and identities from the port's
``AlgorithmEnvironment`` and masks with the port's ``native``.
"""
from __future__ import annotations

import hashlib
import hmac
from typing import Iterable, Mapping

import numpy as np

# `cryptography` is OPTIONAL (same stance as common.encryption): importing
# this module — and workloads.secure_average etc. that reach it — must work
# without the package; X25519 use fails loudly on first call instead.
try:
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        PublicFormat,
    )
    _CRYPTOGRAPHY_ERROR: Exception | None = None
except ModuleNotFoundError as _e:  # pragma: no cover - exercised in CI env
    X25519PrivateKey = X25519PublicKey = None  # type: ignore[assignment]
    Encoding = PublicFormat = None  # type: ignore[assignment]
    _CRYPTOGRAPHY_ERROR = _e


def _require_cryptography() -> None:
    if _CRYPTOGRAPHY_ERROR is not None:
        raise RuntimeError(
            "the 'cryptography' package is required for X25519 DH mask "
            "agreement but is not installed; install it or use the "
            "single-seed masking path (fed.collectives.secure_sum)"
        ) from _CRYPTOGRAPHY_ERROR


from vantage6_tpu_torch import native
from vantage6_tpu_torch.algorithm.context import current_environment


def _tag_bytes(tag: bytes | str | int) -> bytes:
    if isinstance(tag, int):
        tag = str(tag)
    if isinstance(tag, str):
        tag = tag.encode()
    return tag


def _resolve(value):
    """AlgorithmEnvironment identity fields may be values or zero-arg
    factories (lazy RSA keygen); resolve either."""
    return value() if callable(value) else value


def get_identity():
    """This station's org RSA identity cryptor from the run environment, or
    None when the runtime provisioned none (then adverts go unsigned and
    the guarantee stays honest-but-curious)."""
    return _resolve(current_environment().identity)


def get_org_identities() -> Mapping[int, str] | None:
    """The registered identity-pubkey roster (station -> base64 PEM), or
    None when the runtime provisioned none."""
    return _resolve(current_environment().org_identities)


def get_station_secret() -> bytes:
    """This station's LOCAL long-term secret from the active run environment.

    Provisioned per station (node config `station_secret`, or generated by
    the Federation runtime); it never leaves the station — only public keys
    derived from it do.
    """
    secret = current_environment().station_secret
    if not secret:
        raise RuntimeError(
            "this station has no station_secret provisioned — set "
            "`station_secret` in the node config (hex) to enable DH secure "
            "aggregation"
        )
    return secret


def keypair_ikm(station_secret: bytes, tag: bytes | str | int) -> bytes:
    """The 32 secret bytes the per-aggregation X25519 key derives from.

    Exposed (rather than buried in derive_keypair) because the Bonawitz
    dropout-recovery path Shamir-shares exactly these bytes among peers —
    reconstructing them reconstructs the dropped station's pairwise seeds.
    """
    if len(station_secret) < 16:
        raise ValueError("station secret must be >= 16 bytes")
    return hmac.new(
        station_secret,
        b"v6t-x25519-mask-v1:" + _tag_bytes(tag),
        hashlib.sha256,
    ).digest()


def derive_keypair(
    station_secret: bytes, tag: bytes | str | int
) -> tuple[X25519PrivateKey, str]:
    """Deterministic per-aggregation X25519 keypair -> (private, pub hex).

    Deterministic so the two protocol rounds (advertise, upload) re-derive
    the same key without any state carried between stateless task runs.
    X25519 clamps the 32 HMAC bytes into a valid scalar internally.
    """
    return keypair_from_ikm(keypair_ikm(station_secret, tag))


def keypair_from_ikm(ikm: bytes) -> "tuple[X25519PrivateKey, str]":
    _require_cryptography()
    priv = X25519PrivateKey.from_private_bytes(ikm)
    pub = priv.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
    return priv, pub.hex()


# ------------------------------------------------------- advert authentication
def advert_message(
    station: int, pub_hex: str, tag: bytes | str | int
) -> bytes:
    """Canonical bytes an advert signature covers: binds the X25519 pubkey
    to (station index, aggregation tag) so a signature can be replayed
    neither for another station nor for another aggregation."""
    return (
        b"v6t-advert-v1:%d:" % station
        + pub_hex.encode()
        + b":"
        + _tag_bytes(tag)
    )


def sign_advert(
    cryptor, station: int, pub_hex: str, tag: bytes | str | int
) -> str:
    """Sign this station's advert with its organization's RSA identity key
    (an ``encryption.RSACryptor``); returns hex."""
    return cryptor.sign_bytes(advert_message(station, pub_hex, tag)).hex()


def verify_adverts(
    pubkeys: Mapping[int, str],
    identities: Mapping[int, str],
    signatures: Mapping[int, str],
    tag: bytes | str | int,
) -> None:
    """Fail closed unless EVERY advert carries a valid signature from its
    organization's registered identity key. `identities` maps station index
    -> base64 PEM RSA public key (as registered with the server out-of-band
    / at onboarding — the trust root the relay cannot rewrite).

    `identities` is also the ROSTER: the relayed advert set must cover
    exactly these stations. Without this check an active relay could simply
    SHRINK the participant list it shows each station (every remaining
    advert validly signed) until a station has no peers left — at which
    point its 'masked' upload is the plaintext.
    """
    from vantage6_tpu_torch.common.encryption import RSACryptor

    if set(pubkeys) != set(identities):
        missing = sorted(set(identities) - set(pubkeys))
        extra = sorted(set(pubkeys) - set(identities))
        raise ValueError(
            "advert roster does not match the registered identity roster "
            f"(missing adverts for {missing}, unregistered stations {extra})"
            " — a relay dropping participants would strip their masks; "
            "aborting"
        )
    for s, pub_hex in pubkeys.items():
        ident = identities.get(s)
        sig = signatures.get(s)
        if ident is None or sig is None:
            raise ValueError(
                f"station {s}: advert has no identity key/signature — "
                "refusing unauthenticated DH advert"
            )
        if not RSACryptor.verify_signature(
            ident, advert_message(s, pub_hex, tag), bytes.fromhex(sig)
        ):
            raise ValueError(
                f"station {s}: advert signature INVALID — possible "
                "key-substitution (MitM) by the relay; aborting aggregation"
            )


def pairwise_seed(
    priv: X25519PrivateKey,
    peer_pub_hex: str,
    i: int,
    j: int,
    tag: bytes | str | int,
) -> bytes:
    """32-byte ChaCha20 key both ends of pair (i, j) derive identically."""
    _require_cryptography()
    shared = priv.exchange(
        X25519PublicKey.from_public_bytes(bytes.fromhex(peer_pub_hex))
    )
    lo, hi = (i, j) if i < j else (j, i)
    info = b"v6t-pair-mask-v1:%d:%d:" % (lo, hi) + _tag_bytes(tag)
    return hmac.new(shared, info, hashlib.sha256).digest()


def mask_update_dh(
    station_secret: bytes,
    station: int,
    pubkeys: Mapping[int, str] | Iterable[tuple[int, str]],
    values: np.ndarray,
    scale: float = 2.0**16,
    tag: bytes | str | int = b"",
    identities: Mapping[int, str] | None = None,
    signatures: Mapping[int, str] | None = None,
) -> np.ndarray:
    """Quantize `values` and add this station's pairwise DH masks (mod 2^32).

    ``pubkeys`` maps station index -> X25519 public key hex for EVERY
    participant (own entry ignored). Uploads from all participants sum —
    wrapping — to the exact quantized total; no single party (aggregator
    included) can strip another station's masks.

    When ``identities`` (station -> base64 PEM RSA public key) is given,
    every advert must also carry a valid signature in ``signatures``
    (see verify_adverts) — upgrading the guarantee from honest-but-curious
    to active-MitM-resistant relays.
    """
    pubs = dict(pubkeys)
    if identities is not None:
        verify_adverts(pubs, identities, signatures or {}, tag)
    priv, own_pub = derive_keypair(station_secret, tag)
    if station in pubs and pubs[station] != own_pub:
        raise ValueError(
            f"advertised pubkey for station {station} does not match this "
            "station's secret+tag derivation — wrong secret or stale tag?"
        )
    q = native.quantize(np.asarray(values), scale)
    shape = q.shape
    acc = q.reshape(-1).astype(np.uint32)
    with np.errstate(over="ignore"):
        for other, pub_hex in sorted(pubs.items()):
            if other == station:
                continue
            lo, hi = min(station, other), max(station, other)
            seed = pairwise_seed(priv, pub_hex, lo, hi, tag)
            stream = native.chacha20_stream(
                seed, native.pair_nonce(lo, hi), acc.size
            )
            acc = acc + stream if station == lo else acc - stream
    return acc.astype(np.int32).reshape(shape)


def unmask_sum_dh(
    uploads: np.ndarray, scale: float = 2.0**16
) -> np.ndarray:
    """The aggregator's entire job: wrapping sum + dequantize. No keys."""
    return native.dequantize(native.sum_wrapping(np.asarray(uploads)), scale)
