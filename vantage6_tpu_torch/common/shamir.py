"""Shamir secret sharing over GF(256) — the recovery primitive of the
Bonawitz secure-aggregation protocol (common.secureagg_bonawitz).

Byte-wise (t, n) sharing: each byte of the secret is the constant term of an
independent degree-(t-1) polynomial over GF(2^8) (AES polynomial 0x11B);
share for party x is the polynomial evaluated at x (1-based — x=0 IS the
secret and is never issued). Any t shares reconstruct by Lagrange
interpolation at 0; fewer than t reveal nothing (every byte's remaining
polynomial is uniform). Vectorized over the secret's bytes with numpy table
lookups, so sharing a 32-byte seed among 64 parties is microseconds.

Original implementation of the textbook scheme (Shamir 1979); the reference
project has no counterpart (secure aggregation lives in its algorithm repos,
SURVEY.md §2.3).

The port's copy of ``vantage6_tpu/common/shamir.py`` (numpy only): given
the same ``coeff_stream`` its shares are byte-identical to the JAX
package's.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

# ---------------------------------------------------------- GF(256) tables
_EXP = np.zeros(510, np.uint8)
_LOG = np.zeros(256, np.uint8)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    # multiply by the generator 3: x*2 (mod 0x11B) xor x
    _x2 = ((_x << 1) & 0xFF) ^ (0x1B if _x & 0x80 else 0)
    _x = _x2 ^ _x
_EXP[255:] = _EXP[:255]
del _x, _x2, _i


def _gf_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    out = _EXP[_LOG[a].astype(np.int32) + _LOG[b].astype(np.int32)]
    return np.where((a == 0) | (b == 0), np.uint8(0), out)


def _gf_inv(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(256) inverse of 0")
    return _EXP[255 - _LOG[a].astype(np.int32)]


# ------------------------------------------------------------------ scheme
def share_secret(
    secret: bytes, n: int, threshold: int, coeff_stream: bytes
) -> list[bytes]:
    """Split ``secret`` into ``n`` shares, any ``threshold`` of which
    reconstruct it. Returns share bytes for parties x = 1..n (callers map
    party index i -> share [i], i.e. x = i + 1).

    ``coeff_stream`` supplies the (t-1)*len(secret) random polynomial
    coefficient bytes. It MUST be uniformly random and secret (callers
    derive it from a keyed PRF — deterministic per station+tag, so the
    stateless protocol rounds re-derive identical shares); predictable
    coefficients collapse the scheme to plaintext.
    """
    if not 1 <= threshold <= n:
        raise ValueError(f"need 1 <= threshold({threshold}) <= n({n})")
    if n > 255:
        raise ValueError("GF(256) sharing supports at most 255 parties")
    m = len(secret)
    need = (threshold - 1) * m
    if len(coeff_stream) < need:
        raise ValueError(f"coeff_stream too short: {len(coeff_stream)} < {need}")
    sec = np.frombuffer(secret, np.uint8)
    coeffs = np.frombuffer(coeff_stream[:need], np.uint8).reshape(
        threshold - 1, m
    )
    shares = []
    for x in range(1, n + 1):
        xv = np.uint8(x)
        acc = np.zeros(m, np.uint8)
        for c in coeffs[::-1]:  # Horner: (((a_{t-1})x + a_{t-2})x + ...)x + s
            acc = _gf_mul(acc, xv) ^ c
        acc = _gf_mul(acc, xv) ^ sec
        shares.append(acc.tobytes())
    return shares


def reconstruct_secret(
    shares: Mapping[int, bytes], threshold: int
) -> bytes:
    """Lagrange-interpolate at 0 from ``shares`` (party index i -> share,
    evaluated at x = i + 1). Needs at least ``threshold`` entries; uses the
    first ``threshold`` in index order (any subset works)."""
    if len(shares) < threshold:
        raise ValueError(
            f"need {threshold} shares to reconstruct, have {len(shares)}"
        )
    picked = sorted(shares.items())[:threshold]
    xs = [np.uint8(i + 1) for i, _ in picked]
    m = len(picked[0][1])
    out = np.zeros(m, np.uint8)
    for a, (i, share) in enumerate(picked):
        y = np.frombuffer(share, np.uint8)
        if len(y) != m:
            raise ValueError("inconsistent share lengths")
        # l_a(0) = prod_{b != a} x_b / (x_b ^ x_a)
        num = np.uint8(1)
        den = np.uint8(1)
        for b2, x_b in enumerate(xs):
            if b2 == a:
                continue
            num = _gf_mul(num, x_b)
            den = _gf_mul(den, x_b ^ xs[a])
        out ^= _gf_mul(y, _gf_mul(num, _gf_inv(den)))
    return out.tobytes()
