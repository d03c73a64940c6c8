"""End-to-end payload encryption between organizations.

Parity: vantage6-common's encryption module (SURVEY.md §2 item 21) — the
reference encrypts task inputs/results end-to-end so the server only ever
relays ciphertext: a fresh symmetric key per payload, sealed with the
*recipient organization's* RSA public key, with a ``DummyCryptor`` drop-in
when a collaboration is not encrypted.

Scheme here: RSA-OAEP(SHA-256) seals a fresh 256-bit key; the payload itself
is AES-256-GCM (authenticated — tampering with a relayed blob is detected,
which the reference's CTR mode does not give).

Two wire framings (docs/wire_format.md):

- **legacy (v1)**: ``base64(sealed_key) $ base64(nonce) $ base64(ciphertext)``
  — printable JSON-safe strings, ~1.33x inflation on top of the payload.
- **binary (v2, default)**: ``b"V6TE\\x02" | u16 sealed_len | sealed_key |
  nonce(12) | ciphertext`` — zero inflation for file/bytes transports;
  string transports carry ``base64(frame)`` (single encoding, never the
  double base64 of v1-payload-inside-v1-cryptor).

Decryption auto-detects all of these, so old blobs keep decrypting;
``V6T_WIRE_FORMAT=v1`` pins the string API back to the legacy emission.

**Broadcast encryption**: an N-station fan-out of one payload costs ONE
AES-GCM pass — the ciphertext is computed once under a single session key
and only the RSA key-seal differs per recipient (`encrypt_bytes_broadcast`)
— instead of N full encrypt passes. Dedup hits are recorded on
`serialization.WIRE_STATS`.

The port's copy of ``vantage6_tpu/common/encryption.py``: the same frames
(a frame one package encrypts, the other decrypts), with the broadcast
dedup counted on the port's ``WIRE_STATS``.
"""
from __future__ import annotations

import base64
import os
import struct
from pathlib import Path

# `cryptography` is OPTIONAL: environments that never encrypt (CI, the SPMD
# simulator with DummyCryptor collaborations) must still be able to import
# this module — and everything that transitively imports it (node daemon,
# proxy, runtime) — without the package installed. Real crypto use fails
# loudly via _require_cryptography() on FIRST USE, not at import time.
try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa
    _CRYPTOGRAPHY_ERROR: Exception | None = None
except ModuleNotFoundError as _e:  # pragma: no cover - exercised in CI env
    hashes = serialization = padding = rsa = None  # type: ignore[assignment]
    _CRYPTOGRAPHY_ERROR = _e


def _require_cryptography() -> None:
    if _CRYPTOGRAPHY_ERROR is not None:
        raise RuntimeError(
            "the 'cryptography' package is required for RSA/AES payload "
            "encryption but is not installed; install it or use "
            "DummyCryptor (unencrypted collaborations)"
        ) from _CRYPTOGRAPHY_ERROR


def _aesgcm():
    _require_cryptography()
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    return AESGCM


SEPARATOR = "$"

# binary cryptor frame: magic + version, then u16 sealed-key length
ENC_MAGIC = b"V6TE\x02"
_SEALED_LEN = struct.Struct("<H")
_NONCE_LEN = 12


def _binary_wire_default() -> bool:
    """Whether the string API emits base64(binary frame) (v2, default) or
    the legacy '$'-joined format — follows serialization's format switch."""
    from vantage6_tpu_torch.common.serialization import default_format

    return default_format() == "v2"


class CryptorBase:
    """Common base: byte<->str helpers shared by real and dummy cryptors.

    The binary-native surface is ``encrypt_bytes`` / ``decrypt_bytes`` /
    ``encrypt_bytes_broadcast``; the ``*_to_str`` methods wrap it for
    string transports (REST JSON bodies, DB columns) and keep decoding
    every historical format.
    """

    @staticmethod
    def bytes_to_str(data: bytes) -> str:
        return base64.b64encode(data).decode("ascii")

    @staticmethod
    def str_to_bytes(data: str) -> bytes:
        return base64.b64decode(data.encode("ascii"))

    # ---------------------------------------------------- binary-native API
    def encrypt_bytes(self, data: bytes, pubkey_base64: str) -> bytes:
        raise NotImplementedError

    def decrypt_bytes(self, data: "bytes | str") -> bytes:
        raise NotImplementedError

    def encrypt_bytes_broadcast(
        self, data: bytes, pubkeys: "list[str]"
    ) -> "list[bytes]":
        """One blob per recipient. Subclasses override to share the AES
        pass; the base fallback is N independent encrypts."""
        return [self.encrypt_bytes(data, k) for k in pubkeys]

    # ------------------------------------------------------- string wrappers
    def encrypt_bytes_to_str(
        self, data: bytes, pubkey_base64: str, format: "str | None" = None
    ) -> str:
        raise NotImplementedError

    def decrypt_str_to_bytes(self, data: str) -> bytes:
        return self.decrypt_bytes(data)

    def encrypt_bytes_to_str_broadcast(
        self, data: bytes, pubkeys: "list[str]"
    ) -> "list[str]":
        return [
            self.bytes_to_str(b)
            for b in self.encrypt_bytes_broadcast(data, pubkeys)
        ]


class DummyCryptor(CryptorBase):
    """Pass-through 'cryptor' for unencrypted collaborations (the string
    wire stays base64 so its shape is identical either way; the bytes wire
    is the payload itself — zero inflation, zero copies)."""

    def encrypt_bytes(self, data: bytes, pubkey_base64: str = "") -> bytes:
        return bytes(data)

    def decrypt_bytes(self, data: "bytes | str") -> bytes:
        if isinstance(data, str):
            return self.str_to_bytes(data)
        return bytes(data)

    def encrypt_bytes_broadcast(
        self, data: bytes, pubkeys: "list[str]"
    ) -> "list[bytes]":
        blob = bytes(data)
        return [blob] * len(pubkeys)  # shared object — no copies at all

    def encrypt_bytes_to_str(
        self, data: bytes, pubkey_base64: str = "",
        format: "str | None" = None,
    ) -> str:
        return self.bytes_to_str(data)  # base64 either way — same shape

    def encrypt_bytes_to_str_broadcast(
        self, data: bytes, pubkeys: "list[str]"
    ) -> "list[str]":
        wire = self.bytes_to_str(data)  # encode once, share N times
        return [wire] * len(pubkeys)


class RSACryptor(CryptorBase):
    """Hybrid RSA-OAEP + AES-256-GCM cryptor bound to one private key.

    ``private_key`` may be an ``rsa.RSAPrivateKey``, a PEM ``bytes`` blob, or
    a path to a PEM file (created if missing — the reference generates a
    keypair on first node start the same way).
    """

    KEY_BITS = 4096

    def __init__(self, private_key: "rsa.RSAPrivateKey | bytes | str | Path"):
        _require_cryptography()
        if isinstance(private_key, rsa.RSAPrivateKey):
            self.private_key = private_key
        elif isinstance(private_key, bytes):
            self.private_key = serialization.load_pem_private_key(
                private_key, password=None
            )
        else:
            path = Path(private_key)
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                key = self.create_new_rsa_key()
                pem = key.private_bytes(
                    serialization.Encoding.PEM,
                    serialization.PrivateFormat.PKCS8,
                    serialization.NoEncryption(),
                )
                # 0600 from the first instant — no world-readable window.
                fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
                with os.fdopen(fd, "wb") as f:
                    f.write(pem)
            self.private_key = serialization.load_pem_private_key(
                path.read_bytes(), password=None
            )

    @classmethod
    def create_new_rsa_key(cls) -> "rsa.RSAPrivateKey":
        _require_cryptography()
        return rsa.generate_private_key(
            public_exponent=65537, key_size=cls.KEY_BITS
        )

    # ------------------------------------------------------------- public key
    @property
    def public_key_bytes(self) -> bytes:
        return self.private_key.public_key().public_bytes(
            serialization.Encoding.PEM,
            serialization.PublicFormat.SubjectPublicKeyInfo,
        )

    @property
    def public_key_str(self) -> str:
        return self.bytes_to_str(self.public_key_bytes)

    def verify_public_key(self, pubkey_base64: str) -> bool:
        """Does the (server-registered) public key match our private key?"""
        return pubkey_base64 == self.public_key_str

    # -------------------------------------------------------------- identity
    def sign_bytes(self, data: bytes) -> bytes:
        """RSA-PSS(SHA-256) signature binding ``data`` to this organization's
        identity key — used e.g. to authenticate secure-aggregation key
        adverts against an ACTIVE (key-substituting) relay."""
        return self.private_key.sign(
            data,
            padding.PSS(
                mgf=padding.MGF1(hashes.SHA256()),
                salt_length=padding.PSS.MAX_LENGTH,
            ),
            hashes.SHA256(),
        )

    # -------------------------------------------------------------- transport
    @staticmethod
    def _oaep() -> "padding.OAEP":
        return padding.OAEP(
            mgf=padding.MGF1(algorithm=hashes.SHA256()),
            algorithm=hashes.SHA256(),
            label=None,
        )

    def _seal_session_key(self, session_key: bytes, pubkey_base64: str) -> bytes:
        recipient = serialization.load_pem_public_key(
            self.str_to_bytes(pubkey_base64)
        )
        return recipient.encrypt(session_key, self._oaep())

    def encrypt_bytes(self, data: bytes, pubkey_base64: str) -> bytes:
        """Binary v2 frame: one AES-256-GCM pass + one RSA-OAEP key seal."""
        return self.encrypt_bytes_broadcast(data, [pubkey_base64])[0]

    def encrypt_bytes_broadcast(
        self, data: bytes, pubkeys: "list[str]"
    ) -> "list[bytes]":
        """Single-pass broadcast: encrypt ``data`` ONCE under one session
        key, then seal that key per recipient — an N-station broadcast costs
        1 AES-GCM pass + N RSA seals (+ N frame memcpys) instead of N full
        passes. Frames share the same nonce+ciphertext; the session key is
        broadcast-scoped exactly like a reference task's per-payload key.
        """
        if not pubkeys:
            return []
        AESGCM = _aesgcm()
        session_key = AESGCM.generate_key(bit_length=256)
        nonce = os.urandom(_NONCE_LEN)
        ciphertext = AESGCM(session_key).encrypt(nonce, bytes(data), None)
        out = []
        for pubkey in pubkeys:
            sealed = self._seal_session_key(session_key, pubkey)
            out.append(
                b"".join((
                    ENC_MAGIC,
                    _SEALED_LEN.pack(len(sealed)),
                    sealed,
                    nonce,
                    ciphertext,
                ))
            )
        if len(pubkeys) > 1:
            from vantage6_tpu_torch.common.serialization import WIRE_STATS

            WIRE_STATS.record_broadcast(len(pubkeys))
        return out

    def encrypt_bytes_to_str(
        self, data: bytes, pubkey_base64: str, format: "str | None" = None
    ) -> str:
        """String transport: base64(binary frame) under the v2 default, or
        the legacy ``$``-joined format when ``V6T_WIRE_FORMAT=v1`` (or
        ``format="v1"`` per call — e.g. a node's wire_format policy)."""
        legacy = (
            not _binary_wire_default() if format is None
            else format.strip().lower() in ("v1", "json")
        )
        if legacy:
            return self._encrypt_legacy_str(data, pubkey_base64)
        return self.bytes_to_str(self.encrypt_bytes(data, pubkey_base64))

    def encrypt_bytes_to_str_broadcast(
        self, data: bytes, pubkeys: "list[str]"
    ) -> "list[str]":
        if _binary_wire_default():
            return [
                self.bytes_to_str(b)
                for b in self.encrypt_bytes_broadcast(data, pubkeys)
            ]
        return [self._encrypt_legacy_str(data, k) for k in pubkeys]

    def _encrypt_legacy_str(self, data: bytes, pubkey_base64: str) -> str:
        """The historical printable wire shape (kept for old peers and for
        the cross-format compat tests)."""
        AESGCM = _aesgcm()
        session_key = AESGCM.generate_key(bit_length=256)
        nonce = os.urandom(_NONCE_LEN)
        ciphertext = AESGCM(session_key).encrypt(nonce, data, None)
        sealed = self._seal_session_key(session_key, pubkey_base64)
        return SEPARATOR.join(
            self.bytes_to_str(part) for part in (sealed, nonce, ciphertext)
        )

    @staticmethod
    def verify_signature(
        pubkey_base64: str, data: bytes, signature: bytes
    ) -> bool:
        """Check an RSA-PSS(SHA-256) signature against an organization's
        registered public key (base64 PEM, as stored by the server)."""
        _require_cryptography()
        from cryptography.exceptions import InvalidSignature

        pub = serialization.load_pem_public_key(
            CryptorBase.str_to_bytes(pubkey_base64)
        )
        try:
            pub.verify(
                signature,
                data,
                padding.PSS(
                    mgf=padding.MGF1(hashes.SHA256()),
                    salt_length=padding.PSS.MAX_LENGTH,
                ),
                hashes.SHA256(),
            )
            return True
        except InvalidSignature:
            return False

    def decrypt_bytes(self, data: "bytes | str") -> bytes:
        """Decrypt any wire shape this cryptor ever emitted: the binary v2
        frame, base64(v2 frame) strings, and the legacy '$'-joined strings
        — auto-detected, so v1 blobs keep decrypting forever."""
        if isinstance(data, str):
            if SEPARATOR in data:
                return self._decrypt_legacy_str(data)
            try:
                data = self.str_to_bytes(data)
            except Exception as e:
                raise ValueError(
                    "malformed encrypted payload (neither '$'-separated "
                    "legacy format nor base64)"
                ) from e
        data = bytes(data)
        if not data.startswith(ENC_MAGIC):
            # legacy string blob that travelled as bytes
            try:
                text = data.decode("ascii")
            except UnicodeDecodeError:
                text = ""
            if SEPARATOR in text:
                return self._decrypt_legacy_str(text)
            raise ValueError(
                "malformed encrypted payload (no V6TE frame magic)"
            )
        head = len(ENC_MAGIC) + _SEALED_LEN.size
        if len(data) < head:
            raise ValueError("malformed encrypted payload (truncated frame)")
        (sealed_len,) = _SEALED_LEN.unpack(data[len(ENC_MAGIC):head])
        nonce_at = head + sealed_len
        ct_at = nonce_at + _NONCE_LEN
        if len(data) < ct_at:
            raise ValueError(
                "malformed encrypted payload (truncated sealed key/nonce)"
            )
        session_key = self.private_key.decrypt(
            data[head:nonce_at], self._oaep()
        )
        return _aesgcm()(session_key).decrypt(
            data[nonce_at:ct_at], data[ct_at:], None
        )

    def _decrypt_legacy_str(self, data: str) -> bytes:
        try:
            sealed_s, nonce_s, ct_s = data.split(SEPARATOR)
        except ValueError as e:
            raise ValueError(
                "malformed encrypted payload (expected 3 '$'-separated parts)"
            ) from e
        session_key = self.private_key.decrypt(
            self.str_to_bytes(sealed_s), self._oaep()
        )
        return _aesgcm()(session_key).decrypt(
            self.str_to_bytes(nonce_s), self.str_to_bytes(ct_s), None
        )
