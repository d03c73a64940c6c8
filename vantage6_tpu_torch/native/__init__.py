"""Native runtime kernels (host C++ via ctypes) with bit-identical numpy
fallback.

The reference ships no native code (SURVEY.md §2.2); this package is the
native layer for the *cross-host* secure-aggregation path: ChaCha20
pairwise mask generation, fixed-point quantization and wrapping modular sums
at memory bandwidth instead of interpreter speed. Aggregation on the card
never comes here (the port's collectives); nodes use this before uploading
results to a remote control plane.

`lib()` compiles `secureagg.cpp` on first use with g++ into a per-user
cache directory; every entry point transparently falls back to numpy when
no compiler is available (or ``V6T_DISABLE_NATIVE`` is set), and the two
implementations are bit-identical (tested against each other and the RFC
8439 vector).

The port's copy of ``vantage6_tpu/native``: the same C++ contract, bindings
and fallback, built as ``libv6t_torch_secureagg.so`` so that it never
collides with the JAX package's library in the shared cache directory
(each package checks only its own source's mtime).
"""
from __future__ import annotations

import ctypes
import hashlib
import hmac
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np

from vantage6_tpu_torch.common.log import setup_logging

log = setup_logging("vantage6_tpu_torch/native")

_SRC = Path(__file__).parent / "secureagg.cpp"
# not the JAX package's libv6t_secureagg.so: both share the cache
LIB_NAME = "libv6t_torch_secureagg.so"


@lru_cache(maxsize=1)
def lib() -> ctypes.CDLL | None:
    """Compile-on-first-use; None => use the numpy fallback."""
    if os.environ.get("V6T_DISABLE_NATIVE"):
        return None
    # per-user cache dir, 0700: a world-writable shared path (/tmp) would let
    # another local user plant a .so that we'd load into the node process
    default_cache = Path(
        os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache")
    ) / "v6t_native"
    cache_dir = Path(os.environ.get("V6T_NATIVE_CACHE", default_cache))
    cache_dir.mkdir(parents=True, exist_ok=True)
    os.chmod(cache_dir, 0o700)
    so_path = cache_dir / LIB_NAME
    if not so_path.exists() or so_path.stat().st_mtime < _SRC.stat().st_mtime:
        # build to a unique temp name, then atomically publish: concurrent
        # daemons must never CDLL a half-linked file
        fd, tmp_so = tempfile.mkstemp(suffix=".so", dir=cache_dir)
        os.close(fd)
        try:
            subprocess.run(
                [
                    "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    str(_SRC), "-o", tmp_so,
                ],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp_so, so_path)
        except (subprocess.SubprocessError, FileNotFoundError) as e:
            Path(tmp_so).unlink(missing_ok=True)
            log.warning("native build failed (%s); using numpy fallback", e)
            return None
    try:
        dll = ctypes.CDLL(str(so_path))
    except OSError as e:  # pragma: no cover
        log.warning("cannot load %s (%s); using numpy fallback", so_path, e)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    dll.v6t_chacha20_stream.argtypes = [u8p, u8p, u32p, ctypes.c_size_t]
    dll.v6t_pairwise_mask_i32.argtypes = [
        u8p, ctypes.c_uint32, ctypes.c_uint32, i32p, ctypes.c_size_t,
    ]
    dll.v6t_quantize_f32.argtypes = [f32p, i32p, ctypes.c_size_t, ctypes.c_float]
    dll.v6t_dequantize_i32.argtypes = [i32p, f32p, ctypes.c_size_t, ctypes.c_float]
    dll.v6t_sum_i32_wrap.argtypes = [i32p, i32p, ctypes.c_size_t, ctypes.c_size_t]
    return dll


def native_available() -> bool:
    return lib() is not None


# ------------------------------------------------------------ numpy fallback


def _chacha20_stream_np(key: bytes, nonce: bytes, n: int) -> np.ndarray:
    """RFC 8439 ChaCha20 keystream as n uint32 words (vectorized blocks)."""
    assert len(key) == 32 and len(nonce) == 12
    blocks = (n + 15) // 16
    state = np.empty((blocks, 16), np.uint32)
    state[:, 0:4] = np.array(
        [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], np.uint32
    )
    state[:, 4:12] = np.frombuffer(key, np.uint32)
    state[:, 12] = np.arange(blocks, dtype=np.uint32)
    state[:, 13:16] = np.frombuffer(nonce, np.uint32)
    w = state.copy()

    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    def quarter(a, b, c, d):
        w[:, a] += w[:, b]; w[:, d] ^= w[:, a]; w[:, d] = rotl(w[:, d], 16)
        w[:, c] += w[:, d]; w[:, b] ^= w[:, c]; w[:, b] = rotl(w[:, b], 12)
        w[:, a] += w[:, b]; w[:, d] ^= w[:, a]; w[:, d] = rotl(w[:, d], 8)
        w[:, c] += w[:, d]; w[:, b] ^= w[:, c]; w[:, b] = rotl(w[:, b], 7)

    with np.errstate(over="ignore"):
        for _ in range(10):
            quarter(0, 4, 8, 12)
            quarter(1, 5, 9, 13)
            quarter(2, 6, 10, 14)
            quarter(3, 7, 11, 15)
            quarter(0, 5, 10, 15)
            quarter(1, 6, 11, 12)
            quarter(2, 7, 8, 13)
            quarter(3, 4, 9, 14)
        w += state
    return w.reshape(-1)[:n]


def pair_nonce(i: int, j: int) -> bytes:
    """The 96-bit nonce for pair (i, j): words [i, j, 0] little-endian —
    the shared contract of the C++ kernel, the numpy fallback, and the DH
    path (common.secureagg_dh) which reuses the keystream with per-pair
    keys."""
    return (
        int(i).to_bytes(4, "little")
        + int(j).to_bytes(4, "little")
        + b"\x00\x00\x00\x00"
    )


_pair_nonce = pair_nonce


# -------------------------------------------------------------- public API


def chacha20_stream(key: bytes, nonce: bytes, n: int) -> np.ndarray:
    """n uint32 keystream words."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError(
            f"key must be 32 bytes and nonce 12 (got {len(key)}/{len(nonce)})"
        )
    dll = lib()
    if dll is None:
        return _chacha20_stream_np(key, nonce, n)
    out = np.empty(n, np.uint32)
    dll.v6t_chacha20_stream(
        np.frombuffer(bytearray(key), np.uint8).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)
        ),
        np.frombuffer(bytearray(nonce), np.uint8).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)
        ),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n,
    )
    return out


def quantize(x: np.ndarray, scale: float) -> np.ndarray:
    """float32 -> fixed-point int32 (np.rint semantics on both paths).

    Raises when a value itself exceeds the int32 range at this scale —
    silent wrap-around here would corrupt the aggregate undetectably.
    Callers must ALSO budget for the sum: pick
    ``scale <= 2**31 / (n_parties * max|value|)``.
    """
    x = np.ascontiguousarray(x, np.float32)
    # the guard must use the SAME float32 product the kernels compute:
    # f32 multiplication is magnitude-monotonic, so checking the peak in f32
    # bounds every element; any f32 < 2^31 is <= 2147483520 and casts safely
    peak = np.float32(np.max(np.abs(x))) if x.size else np.float32(0)
    # NOT (prod < limit), so NaN/inf inputs are rejected too — NaN would
    # sail through a `prod >= limit` check and corrupt the aggregate
    prod = np.float32(peak) * np.float32(scale)
    if not prod < np.float32(2.0**31):
        raise ValueError(
            f"quantization overflow/invalid: max |value| {float(peak):g} * "
            f"scale {scale:g} not inside int32 range (NaN/inf values are "
            "rejected here too)"
        )
    dll = lib()
    if dll is None:
        return np.rint(x * scale).astype(np.int32)
    out = np.empty(x.size, np.int32)
    dll.v6t_quantize_f32(
        x.reshape(-1).ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        x.size,
        scale,
    )
    return out.reshape(x.shape)


def dequantize(q: np.ndarray, scale: float) -> np.ndarray:
    q = np.ascontiguousarray(q, np.int32)
    dll = lib()
    if dll is None:
        # float32 cast-then-divide, matching the C++ kernel bit-for-bit
        # (float64 division would differ for |q| > 2^24)
        return q.astype(np.float32) / np.float32(scale)
    out = np.empty(q.size, np.float32)
    dll.v6t_dequantize_i32(
        q.reshape(-1).ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        q.size,
        scale,
    )
    return out.reshape(q.shape)


def derive_mask_key(seed: bytes, tag: bytes | str | int) -> bytes:
    """Per-aggregation 32-byte subkey: HMAC-SHA256(seed, context || tag).

    The pairwise mask nonce is only (i, j) — it carries no round/task
    identity — so REUSING one key across two aggregations produces
    byte-identical masks, and the relaying server (exactly the party the
    threat model defends against) could difference a station's two uploads
    to cancel them and recover the quantized plaintext delta. Every
    aggregation must therefore run under a fresh subkey; all parties derive
    it from the provisioned long-term seed plus a shared per-aggregation
    ``tag`` (task id, round number, …) that need not be secret.
    """
    if isinstance(tag, int):
        tag = str(tag)
    if isinstance(tag, str):
        tag = tag.encode()
    return hmac.new(seed, b"v6t-secureagg-mask-v1:" + tag,
                    hashlib.sha256).digest()


def add_pairwise_masks(
    seed: bytes,
    station: int,
    n_stations: int,
    quantized: np.ndarray,
    tag: bytes | str | int = b"",
) -> np.ndarray:
    """Return `quantized` plus this station's pairwise masks (mod 2^32).

    For each pair (i, j), i < j, station i adds +PRG, station j adds -PRG;
    summed over all stations the masks cancel exactly. The keystream key is
    ``derive_mask_key(seed, tag)`` — pass a distinct ``tag`` per aggregation
    (see that function for why reuse is a real unmasking attack).
    """
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    seed = derive_mask_key(seed, tag)
    q = np.ascontiguousarray(quantized, np.int32)
    dll = lib()
    if dll is not None:
        buf = q.reshape(-1).copy()
        dll.v6t_pairwise_mask_i32(
            np.frombuffer(bytearray(seed), np.uint8).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)
            ),
            int(station),
            int(n_stations),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            buf.size,
        )
        return buf.reshape(q.shape)
    acc = q.reshape(-1).astype(np.uint32)
    with np.errstate(over="ignore"):
        for other in range(n_stations):
            if other == station:
                continue
            i, j = min(station, other), max(station, other)
            stream = _chacha20_stream_np(seed, _pair_nonce(i, j), acc.size)
            acc = acc + stream if station == i else acc - stream
    return acc.astype(np.int32).reshape(q.shape)


def sum_wrapping(stacked: np.ndarray) -> np.ndarray:
    """Column sum of [S, n] int32 with mod-2^32 wrap-around."""
    x = np.ascontiguousarray(stacked, np.int32)
    if x.ndim == 1:
        x = x[None]
    s, n = x.shape[0], x[0].size
    dll = lib()
    if dll is None:
        with np.errstate(over="ignore"):
            return (
                x.reshape(s, -1)
                .astype(np.uint32)
                .sum(axis=0, dtype=np.uint32)
                .astype(np.int32)
                .reshape(x.shape[1:])
            )
    out = np.empty(n, np.int32)
    dll.v6t_sum_i32_wrap(
        x.reshape(-1).ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        s,
        n,
    )
    return out.reshape(x.shape[1:])


# ------------------------------------------------------- high-level helpers


def mask_update(
    seed: bytes,
    station: int,
    n_stations: int,
    values: np.ndarray,
    scale: float = 2.0**16,
    tag: bytes | str | int = b"",
) -> np.ndarray:
    """What a node uploads: quantized values + this station's masks.

    ``tag`` must be shared by all parties of ONE aggregation and differ
    between aggregations (see derive_mask_key)."""
    return add_pairwise_masks(
        seed, station, n_stations, quantize(values, scale), tag=tag
    )


def unmask_sum(masked: np.ndarray, scale: float = 2.0**16) -> np.ndarray:
    """What the aggregator computes: masks cancel in the wrapping sum."""
    return dequantize(sum_wrapping(masked), scale)
