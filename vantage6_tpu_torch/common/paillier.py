"""Paillier additively-homomorphic encryption (host-side, pure python).

Parity: the reference's secure-sum story is Paillier inside algorithm repos
(SURVEY.md §2.3 "secure aggregation"; §7 hard part 2). Homomorphic bigint is
the wrong tool on a tensor core, so the fast path is additive masking
(fed.collectives.secure_sum on the card, vantage6_tpu_torch.native
cross-host) — and THIS module exists so the two can be proven equivalent:
the parity tests (tests/test_torch_paillier.py) aggregate the same
quantized vectors through both paths and compare exactly. It is also a
complete, usable implementation for deployments that require the classical
scheme (station encrypts, untrusted server adds ciphertexts, only the key
holder decrypts the sum).

Scheme (Paillier 1999), with the standard g = n + 1 simplification:
  keygen:  n = p*q (p, q safe-size primes), λ = lcm(p-1, q-1), μ = λ⁻¹ mod n
  encrypt: c = (1 + m·n) · rⁿ  mod n²       (r random in Z*_n)
  add:     c₁·c₂ mod n²  decrypts to m₁+m₂  (the homomorphism)
  decrypt: m = L(c^λ mod n²) · μ mod n,  L(x) = (x-1)/n

Signed values are encoded into Z_n by wrap-around: plaintexts in
(-n/2, n/2) survive any number of additions that keep the true sum inside
that range — the same fixed-point contract as the masking path's int32.

Security note: textbook Paillier is IND-CPA under DCRA; this implementation
targets correctness/parity, uses `secrets` for all randomness, and does NOT
attempt side-channel hardening (python bigints are not constant-time).

The port's copy of ``vantage6_tpu/common/paillier.py`` (python big
integers; no framework): under the same key and blinding ``r`` its
ciphertexts are the JAX package's integers, and each package decrypts the
other's.
"""
from __future__ import annotations

import dataclasses
import math
import secrets
from typing import Iterable, Sequence

import numpy as np

# Miller-Rabin rounds: error < 4^-64 per prime, plenty beyond any test need.
_MR_ROUNDS = 64

_SMALL_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
]


def _is_probable_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(_MR_ROUNDS):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        cand = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(cand):
            return cand


@dataclasses.dataclass(frozen=True)
class PublicKey:
    n: int

    @property
    def n_sq(self) -> int:
        return self.n * self.n

    @property
    def max_abs_plaintext(self) -> int:
        """Signed plaintexts must stay strictly inside ±n/2."""
        return self.n // 2

    def encrypt(self, m: int, r: int | None = None) -> int:
        """Encrypt a signed int; r (blinding) is drawn from Z*_n if omitted."""
        m = int(m)
        if abs(m) >= self.max_abs_plaintext:
            raise ValueError(
                f"plaintext magnitude {m} outside ±n/2 — pick a larger key "
                "or smaller fixed-point scale"
            )
        n, n_sq = self.n, self.n_sq
        if r is None:
            while True:
                r = secrets.randbelow(n - 1) + 1
                if math.gcd(r, n) == 1:
                    break
        elif not (0 < r < n) or math.gcd(r, n) != 1:
            raise ValueError("r must be in Z*_n")
        # g = n+1 => g^m = 1 + m*n (mod n^2): one mulmod instead of a powmod
        return ((1 + (m % n) * n) % n_sq) * pow(r, n, n_sq) % n_sq

    def add(self, c1: int, c2: int) -> int:
        """Ciphertext of m1 + m2."""
        return (c1 * c2) % self.n_sq

    def add_plain(self, c: int, m: int) -> int:
        """Ciphertext of m_c + m (no fresh blinding needed for parity use)."""
        return c * (1 + (int(m) % self.n) * self.n) % self.n_sq

    def mul_plain(self, c: int, k: int) -> int:
        """Ciphertext of k * m_c (k signed)."""
        k = int(k) % self.n
        return pow(c, k, self.n_sq)

    def encrypt_vector(self, values: Iterable[int]) -> list[int]:
        return [self.encrypt(int(v)) for v in values]

    def add_vectors(self, a: Sequence[int], b: Sequence[int]) -> list[int]:
        if len(a) != len(b):
            raise ValueError("length mismatch")
        return [self.add(x, y) for x, y in zip(a, b)]


@dataclasses.dataclass(frozen=True)
class PrivateKey:
    public: PublicKey
    lam: int   # λ = lcm(p-1, q-1)
    mu: int    # λ⁻¹ mod n

    def decrypt(self, c: int) -> int:
        """Decrypt to a SIGNED int in (-n/2, n/2]."""
        n, n_sq = self.public.n, self.public.n_sq
        if not (0 < c < n_sq):
            raise ValueError("ciphertext out of range")
        m = ((pow(c, self.lam, n_sq) - 1) // n) * self.mu % n
        return m - n if m > n // 2 else m

    def decrypt_vector(self, cts: Iterable[int]) -> list[int]:
        return [self.decrypt(c) for c in cts]


def keygen(bits: int = 2048) -> tuple[PublicKey, PrivateKey]:
    """Generate a keypair with an n of ~`bits` bits.

    512 is fine for tests; use >= 2048 for anything real.
    """
    if bits < 64:
        raise ValueError("key too small to be meaningful")
    while True:
        p = _random_prime(bits // 2)
        q = _random_prime(bits - bits // 2)
        if p != q:
            n = p * q
            if n.bit_length() >= bits:
                break
    lam = (p - 1) * (q - 1) // math.gcd(p - 1, q - 1)
    pk = PublicKey(n=n)
    return pk, PrivateKey(public=pk, lam=lam, mu=pow(lam, -1, n))


# ----------------------------------------------------- fixed-point vectors
# The same quantization contract as the masking path (native):
# float -> round(x * scale) as exact ints, so a Paillier-aggregated sum and a
# masking-aggregated sum of identical inputs are EQUAL integers, not merely
# close floats — that equality is what the parity tests assert.


def quantize(x: np.ndarray, scale: float) -> list[int]:
    """np.rint fixed-point, matching native.quantize bit-for-bit (then lifted
    to python ints, where Paillier has no 32-bit wrap to worry about)."""
    return [int(v) for v in np.rint(
        np.ascontiguousarray(x, np.float32) * np.float32(scale)
    ).astype(np.int64)]


def dequantize(values: Sequence[int], scale: float) -> np.ndarray:
    return (np.asarray(values, np.float64) / float(scale)).astype(np.float32)


def secure_sum_paillier(
    pk: PublicKey,
    sk: PrivateKey,
    station_vectors: Sequence[np.ndarray],
    scale: float = 2.0**16,
) -> np.ndarray:
    """Reference-shaped secure sum: each station encrypts its quantized
    vector; the (untrusted) aggregator multiplies ciphertexts element-wise;
    only the key holder decrypts the total. Returns the dequantized sum."""
    if not station_vectors:
        raise ValueError("no stations")
    encrypted = [
        pk.encrypt_vector(quantize(np.asarray(v), scale))
        for v in station_vectors
    ]
    agg = encrypted[0]
    for ct in encrypted[1:]:
        agg = pk.add_vectors(agg, ct)   # the aggregator's entire job
    return dequantize(sk.decrypt_vector(agg), scale)
