"""The port's native secure-aggregation kernels and Shamir sharing against
the JAX package's, on the CPU.

The first part is ``tests/test_native.py`` with its imports switched to
the port (RFC vector, C++ <-> numpy equivalence, mask cancellation, the
node-upload/server-sum flow), and ``test_secureagg_bonawitz.py``'s
``TestShamir``. The cross-package cases run both packages on the same
seeded numpy inputs: the ChaCha20 stream, masked uploads and the wrapping
sum bit for bit (each package's C++ and numpy paths), and Shamir shares
and their reconstruction byte for byte.
"""
import importlib
import os
import stat

import numpy as np
import pytest

from vantage6_tpu_torch import native
from vantage6_tpu_torch.common import shamir

JN = importlib.import_module("vantage6_tpu.native")
JShamir = importlib.import_module("vantage6_tpu.common.shamir")


RFC_KEY = bytes(range(32))
RFC_NONCE = bytes.fromhex("000000090000004a00000000")
# RFC 8439 §2.3.2 test vector, block counter 1 (first block here is counter 0)
RFC_BLOCK1_FIRST_WORDS = [0xE4E7F110, 0x15593BD1, 0x1FDD0F50, 0xC47120A3]


def _without_native(monkeypatch, fn):
    """``fn()`` with both packages on their numpy fallback."""
    monkeypatch.setenv("V6T_DISABLE_NATIVE", "1")
    native.lib.cache_clear()
    JN.lib.cache_clear()
    try:
        return fn()
    finally:
        monkeypatch.delenv("V6T_DISABLE_NATIVE")
        native.lib.cache_clear()
        JN.lib.cache_clear()


# ------------------------------------------- tests/test_native.py, ported
def test_chacha20_rfc_vector():
    # words 16..19 are the start of block counter 1
    stream = native._chacha20_stream_np(RFC_KEY, RFC_NONCE, 32)
    assert list(stream[16:20]) == RFC_BLOCK1_FIRST_WORDS


@pytest.mark.skipif(not native.native_available(), reason="no g++")
class TestNativeVsNumpy:
    def test_chacha20_bit_identical(self):
        n = 1000
        a = native.chacha20_stream(RFC_KEY, RFC_NONCE, n)  # native
        b = native._chacha20_stream_np(RFC_KEY, RFC_NONCE, n)
        np.testing.assert_array_equal(a, b)

    def test_masking_bit_identical(self, monkeypatch):
        rng = np.random.default_rng(0)
        vals = rng.normal(0, 3, 513).astype(np.float32)
        seed = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        q = native.quantize(vals, 2.0**16)
        m_native = native.add_pairwise_masks(seed, 2, 5, q)
        m_fallback = _without_native(
            monkeypatch, lambda: native.add_pairwise_masks(seed, 2, 5, q))
        np.testing.assert_array_equal(m_native, m_fallback)

    def test_quantize_roundtrip_identical(self):
        rng = np.random.default_rng(1)
        vals = rng.normal(0, 10, 777).astype(np.float32)
        q = native.quantize(vals, 2.0**16)
        back = native.dequantize(q, 2.0**16)
        assert np.max(np.abs(back - vals)) < 1.0 / 2.0**15

    def test_dequantize_bit_identical_beyond_2p24(self, monkeypatch):
        # |q| > 2^24: float64-then-cast would differ from the C++ kernel's
        # float32 cast-then-divide
        q = np.asarray([16777217, -16777219, 2**30], np.int32)
        a = native.dequantize(q, 2.0**16)
        b = _without_native(monkeypatch,
                            lambda: native.dequantize(q, 2.0**16))
        np.testing.assert_array_equal(a, b)

    def test_guard_boundary_in_float32(self):
        # guard computes in the kernels' own float32 arithmetic: the largest
        # f32 below 32768 quantizes safely (product 2147483520 < 2^31) while
        # 32768.0 itself is rejected
        edge = np.nextafter(np.float32(32768.0), np.float32(0))
        q = native.quantize(np.asarray([edge], np.float32), 2.0**16)
        assert q[0] == 2147483520
        with pytest.raises(ValueError, match="overflow"):
            native.quantize(np.asarray([32768.0], np.float32), 2.0**16)

    def test_chacha_stream_validates_lengths(self):
        with pytest.raises(ValueError, match="32 bytes"):
            native.chacha20_stream(b"short", b"0" * 12, 4)


class TestSecureFlow:
    def test_masks_cancel_exactly(self):
        rng = np.random.default_rng(7)
        n_stations, dim = 6, 1024
        seed = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        updates = rng.normal(0, 1, (n_stations, dim)).astype(np.float32)
        uploads = np.stack(
            [
                native.mask_update(seed, s, n_stations, updates[s])
                for s in range(n_stations)
            ]
        )
        # an individual upload reveals nothing recognizable: it differs
        # wildly from its quantized plaintext
        q0 = native.quantize(updates[0], 2.0**16)
        assert np.mean(uploads[0] == q0) < 0.01
        total = native.unmask_sum(uploads)
        np.testing.assert_allclose(
            total, updates.sum(axis=0), atol=n_stations / 2.0**15
        )

    def test_two_stations(self):
        seed = b"s" * 32
        a = native.mask_update(seed, 0, 2,
                               np.asarray([1.5, -2.25], np.float32))
        b = native.mask_update(seed, 1, 2,
                               np.asarray([0.5, 0.25], np.float32))
        out = native.unmask_sum(np.stack([a, b]))
        np.testing.assert_allclose(out, [2.0, -2.0], atol=1e-4)

    def test_wrap_sum_matches_int_semantics(self):
        x = np.asarray(
            [[2**31 - 1, -5], [1, -5]], np.int32
        )  # overflow wraps, like on-device int32
        out = native.sum_wrapping(x)
        assert out[0] == -(2**31) + 0  # wrapped
        assert out[1] == -10

    def test_bad_seed_rejected(self):
        with pytest.raises(ValueError, match="32 bytes"):
            native.add_pairwise_masks(b"short", 0, 2, np.zeros(4, np.int32))

    def test_quantize_overflow_raises_not_wraps(self):
        # 2.3e6 * 2^16 >> int32: silent wrap would corrupt aggregates
        big = np.asarray([2.3e6], np.float32)
        with pytest.raises(ValueError, match="overflow"):
            native.quantize(big, 2.0**16)
        assert native.quantize(big, 256.0)[0] > 0  # fits at a smaller scale


def test_fallback_flow_without_native(monkeypatch):
    def flow():
        assert not native.native_available()
        seed = b"x" * 32
        ups = [
            native.mask_update(seed, s, 3, np.full(10, float(s), np.float32))
            for s in range(3)
        ]
        return native.unmask_sum(np.stack(ups))

    out = _without_native(monkeypatch, flow)
    np.testing.assert_allclose(out, np.full(10, 3.0), atol=1e-3)


# --------------------------------- the library's own name and cache dir
@pytest.mark.skipif(not native.native_available(), reason="no g++")
def test_library_name_and_private_cache(tmp_path, monkeypatch):
    """The port builds ``libv6t_torch_secureagg.so`` (never the JAX
    package's ``libv6t_secureagg.so``) into a 0700 cache directory, from
    its own source."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("V6T_NATIVE_CACHE", str(cache))
    native.lib.cache_clear()
    try:
        dll = native.lib()
        assert dll is not None
        assert os.path.basename(dll._name) == native.LIB_NAME
        assert native.LIB_NAME != "libv6t_secureagg.so"
        assert sorted(os.listdir(cache)) == [native.LIB_NAME]
        assert stat.S_IMODE(os.stat(cache).st_mode) == 0o700
        np.testing.assert_array_equal(
            native.chacha20_stream(RFC_KEY, RFC_NONCE, 64),
            native._chacha20_stream_np(RFC_KEY, RFC_NONCE, 64))
    finally:
        monkeypatch.delenv("V6T_NATIVE_CACHE")
        native.lib.cache_clear()


# ------------------------------------------------------- cross-package
@pytest.mark.parametrize("path", ["native", "numpy"])
class TestAgainstJax:
    """Both packages on the same seeded inputs, through their C++ kernels
    and through their numpy fallbacks: equal words, bit for bit."""

    def _run(self, monkeypatch, path, fn):
        return _without_native(monkeypatch, fn) if path == "numpy" else fn()

    @pytest.mark.parametrize("n", [1, 17, 1000])
    def test_chacha20_stream(self, monkeypatch, path, n):
        rng = np.random.default_rng(n)
        key = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        nonce = native.pair_nonce(3, 11)
        assert nonce == JN.pair_nonce(3, 11)
        a, b = self._run(monkeypatch, path, lambda: (
            native.chacha20_stream(key, nonce, n),
            JN.chacha20_stream(key, nonce, n)))
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)

    def test_masked_uploads_and_wrapping_sum(self, monkeypatch, path):
        rng = np.random.default_rng(42)
        n_st, dim, scale = 5, 1031, 2.0**14
        seed = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        vals = rng.normal(0, 4, (n_st, dim)).astype(np.float32)

        def both():
            ups = [np.stack([m.mask_update(seed, s, n_st, vals[s], scale,
                                           tag="agg-7")
                             for s in range(n_st)]) for m in (native, JN)]
            sums = [m.sum_wrapping(u) for m, u in zip((native, JN), ups)]
            outs = [m.unmask_sum(u, scale) for m, u in zip((native, JN), ups)]
            return ups, sums, outs

        ups, sums, outs = self._run(monkeypatch, path, both)
        np.testing.assert_array_equal(ups[0], ups[1])
        np.testing.assert_array_equal(sums[0], sums[1])
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_allclose(outs[0], vals.sum(0), atol=n_st / scale)

    def test_quantize_and_mask_key(self, monkeypatch, path):
        rng = np.random.default_rng(9)
        x = rng.normal(0, 100, 4097).astype(np.float32)
        qa, qb = self._run(monkeypatch, path, lambda: (
            native.quantize(x, 2.0**12), JN.quantize(x, 2.0**12)))
        np.testing.assert_array_equal(qa, qb)
        for tag in (b"t", "round-3", 17):
            assert (native.derive_mask_key(b"k" * 32, tag)
                    == JN.derive_mask_key(b"k" * 32, tag))


# ------------------- test_secureagg_bonawitz.py::TestShamir, ported
class TestShamir:
    def test_roundtrip_and_threshold(self):
        sec = bytes(range(32))
        shares = shamir.share_secret(sec, 6, 4, bytes(96))
        # deterministic stream is a caller concern; any t shares reconstruct
        got = shamir.reconstruct_secret(
            {i: s for i, s in enumerate(shares) if i in (0, 2, 3, 5)}, 4
        )
        assert got == sec
        with pytest.raises(ValueError, match="need 4 shares"):
            shamir.reconstruct_secret({0: shares[0], 1: shares[1]}, 4)

    def test_below_threshold_reveals_nothing(self):
        """With random coefficients, t-1 shares are consistent with EVERY
        candidate secret byte — information-theoretic hiding."""
        sec = b"\x00" * 4
        shares = shamir.share_secret(sec, 3, 2, os.urandom(4))
        # one share: for any hypothetical secret there exists a line through
        # (x, y) and (0, s') — so a single share fixes nothing; verify by
        # constructing such a line explicitly for a wrong secret
        x, y = 1, np.frombuffer(shares[0], np.uint8)
        wrong = np.frombuffer(b"\xAA" * 4, np.uint8)
        slope = shamir._gf_mul(y ^ wrong, shamir._gf_inv(np.uint8(x)))
        y_again = shamir._gf_mul(slope, np.uint8(x)) ^ wrong
        assert bytes(y_again) == shares[0]


class TestShamirAgainstJax:
    def test_tables_equal(self):
        np.testing.assert_array_equal(shamir._EXP, JShamir._EXP)
        np.testing.assert_array_equal(shamir._LOG, JShamir._LOG)

    @pytest.mark.parametrize("n,t,m", [(2, 2, 32), (6, 4, 32), (32, 17, 64)])
    def test_shares_and_reconstruction_byte_for_byte(self, n, t, m):
        rng = np.random.default_rng(n * 100 + t)
        sec = rng.integers(0, 256, m, dtype=np.uint8).tobytes()
        coeffs = rng.integers(0, 256, (t - 1) * m or 1,
                              dtype=np.uint8).tobytes()
        ours = shamir.share_secret(sec, n, t, coeffs)
        theirs = JShamir.share_secret(sec, n, t, coeffs)
        assert ours == theirs
        picked = sorted(rng.choice(n, t, replace=False).tolist())
        sub = {i: ours[i] for i in picked}
        assert (shamir.reconstruct_secret(sub, t)
                == JShamir.reconstruct_secret(sub, t) == sec)

    def test_field_ops_exhaustive(self):
        a = np.repeat(np.arange(256, dtype=np.uint8), 256)
        b = np.tile(np.arange(256, dtype=np.uint8), 256)
        np.testing.assert_array_equal(shamir._gf_mul(a, b),
                                      JShamir._gf_mul(a, b))
        nz = np.arange(1, 256, dtype=np.uint8)
        np.testing.assert_array_equal(shamir._gf_inv(nz), JShamir._gf_inv(nz))
        with pytest.raises(ZeroDivisionError):
            shamir._gf_inv(np.uint8(0))
