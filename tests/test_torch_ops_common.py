"""The port's common layer, on the CPU: log, faults' REST point, context,
artifact, encryption and rest.

A copy of ``tests/test_common.py`` (encryption, contexts, artifact refs,
logging) and of ``tests/test_wire_format.py``'s ``TestBroadcastEncryption``
with their imports switched to the port. Then the cross-package cases: a
v2 frame (and a legacy string) that one package encrypts, the other
decrypts, both ways, with the RSA keys shared as PEM files; the port's own
cases: ``rest.py`` imports without ``requests`` and raises naming it on
the first request, a ``RestSession`` round trip to a local HTTP server
counted in ``REST_STATS`` and the telemetry ``rest`` collector, and a
``Federation`` run's RSA identity signing an advert that its
``org_identities`` registry verifies.
"""
import importlib
import json
import logging
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from vantage6_tpu_torch.common.artifact import (
    content_digest,
    digests_match,
    parse_ref,
    same_artifact,
)
from vantage6_tpu_torch.common.context import (
    ConfigurationError,
    ConfigurationManager,
    NodeContext,
    ServerContext,
)
from vantage6_tpu_torch.common.encryption import CryptorBase, DummyCryptor, RSACryptor
from vantage6_tpu_torch.common.log import setup_logging
from vantage6_tpu_torch.common.serialization import WIRE_STATS


@pytest.fixture(scope="module")
def rsa_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("rsa")


@pytest.fixture(scope="module")
def rsa_pair(rsa_dir):
    # real-crypto tests skip (not fail) where cryptography is not installed;
    # the module still collects so DummyCryptor/context/artifact tests run
    pytest.importorskip("cryptography")
    # 4096-bit keygen is slow; one pair for the whole module.
    a = RSACryptor(rsa_dir / "a.pem")
    b = RSACryptor(rsa_dir / "b.pem")
    return a, b


class TestEncryption:
    def test_dummy_roundtrip(self):
        c = DummyCryptor()
        blob = b'{"method": "average"}'
        wire = c.encrypt_bytes_to_str(blob, "")
        assert isinstance(wire, str)
        assert c.decrypt_str_to_bytes(wire) == blob

    def test_rsa_roundtrip_between_orgs(self, rsa_pair):
        alice, bob = rsa_pair
        blob = b"federated weights " * 100
        wire = alice.encrypt_bytes_to_str(blob, bob.public_key_str)
        assert wire != CryptorBase.bytes_to_str(blob)
        assert bob.decrypt_str_to_bytes(wire) == blob

    def test_wrong_recipient_fails(self, rsa_pair):
        alice, bob = rsa_pair
        wire = alice.encrypt_bytes_to_str(b"secret", alice.public_key_str)
        with pytest.raises(Exception):
            bob.decrypt_str_to_bytes(wire)

    def test_tamper_detected(self, rsa_pair):
        alice, bob = rsa_pair
        wire = alice.encrypt_bytes_to_str(b"secret", bob.public_key_str)
        head, _, tail = wire.rpartition("$")
        tampered = head + "$" + ("A" * len(tail))
        with pytest.raises(Exception):
            bob.decrypt_str_to_bytes(tampered)

    def test_key_persistence(self, rsa_dir, rsa_pair):
        a, _ = rsa_pair
        again = RSACryptor(rsa_dir / "a.pem")
        assert again.public_key_str == a.public_key_str
        assert a.verify_public_key(again.public_key_str)
        # created 0600 from the first instant
        assert (rsa_dir / "a.pem").stat().st_mode & 0o777 == 0o600

    def test_malformed_payload(self, rsa_pair):
        a, _ = rsa_pair
        with pytest.raises(ValueError, match="malformed"):
            a.decrypt_str_to_bytes("notthreeparts")

    def test_missing_cryptography_raises_clearly(self, monkeypatch):
        """With `cryptography` absent the module must still import (lazy
        import satellite) and real-crypto entry points must raise a CLEAR
        RuntimeError on first use, not an ImportError mid-operation."""
        from vantage6_tpu_torch.common import encryption as enc

        monkeypatch.setattr(
            enc, "_CRYPTOGRAPHY_ERROR", ModuleNotFoundError("cryptography")
        )
        with pytest.raises(RuntimeError, match="cryptography"):
            RSACryptor.create_new_rsa_key()
        with pytest.raises(RuntimeError, match="cryptography"):
            RSACryptor(b"not-a-key")
        # the unencrypted path must stay fully functional
        c = DummyCryptor()
        assert c.decrypt_str_to_bytes(c.encrypt_bytes_to_str(b"x", "")) == b"x"


class TestArtifactRef:
    def test_parse_full(self):
        r = parse_ref(
            "harbor2.vantage6.ai/algorithms/average:4.0@sha256:" + "ab" * 32
        )
        assert r.registry == "harbor2.vantage6.ai"
        assert r.name == "algorithms/average"
        assert r.tag == "4.0"
        assert r.digest.startswith("sha256:")
        assert parse_ref(r.full) == r

    def test_bare_name_with_tag(self):
        r = parse_ref("v6-average-py:latest")
        assert r.registry == "" and r.name == "v6-average-py"

    def test_registry_heuristic(self):
        # no dot/port -> it's a path component, not a registry
        r = parse_ref("algorithms/average")
        assert r.registry == "" and r.name == "algorithms/average"

    def test_digest_check(self):
        blob = b"algorithm module bytes"
        ref = f"average@{content_digest(blob)}"
        assert digests_match(ref, blob)
        assert not digests_match(ref, b"tampered")
        assert digests_match("average:1.0", b"anything")  # unpinned

    def test_same_artifact_ignores_digest_and_defaults_latest(self):
        assert same_artifact("avg", "avg:latest")
        assert same_artifact("avg:1.0@sha256:" + "0" * 64, "avg:1.0")
        assert not same_artifact("avg:1.0", "avg:2.0")

    def test_invalid(self):
        with pytest.raises(ValueError):
            parse_ref("UPPER CASE BAD!!")


class TestContexts:
    def test_node_context_requires_keys(self, tmp_path, monkeypatch):
        monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
        monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
        monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path / "state"))
        with pytest.raises(ConfigurationError, match="api_url"):
            NodeContext.create("n1", {"api_key": "k"})
        ctx = NodeContext.create(
            "n1", {"api_url": "http://localhost:7601", "api_key": "k"}
        )
        assert ctx.api_url == "http://localhost:7601"
        assert NodeContext.config_exists("n1")
        assert NodeContext.available_configurations() == ["n1"]
        # data/log dirs materialize under XDG roots
        assert ctx.data_dir.is_dir() and ctx.log_dir.is_dir()

    def test_server_context_defaults(self, tmp_path, monkeypatch):
        monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
        monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
        monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path / "state"))
        ctx = ServerContext.create("s1", {})
        assert ctx.port == ServerContext.DEFAULT_PORT
        assert ctx.uri.startswith("sqlite:///")

    def test_env_interpolation(self, monkeypatch):
        monkeypatch.setenv("SECRET_DB", "/data/x.csv")
        raw = {"api_url": "u", "api_key": "k", "databases": [{"uri": "${SECRET_DB}"}]}
        cfg = ConfigurationManager("node").validate(raw)
        assert cfg["databases"][0]["uri"] == "/data/x.csv"
        # the caller's dict keeps its placeholder (saved configs must not
        # leak resolved secrets)
        assert raw["databases"][0]["uri"] == "${SECRET_DB}"

    def test_duplicate_create_rejected(self, tmp_path, monkeypatch):
        monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
        monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
        monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path / "state"))
        ServerContext.create("dup", {})
        with pytest.raises(ConfigurationError, match="exists"):
            ServerContext.create("dup", {})


def test_setup_logging_idempotent(tmp_path):
    lg1 = setup_logging("v6t-torch-test", level=logging.DEBUG, log_dir=tmp_path)
    n = len(lg1.handlers)
    lg2 = setup_logging("v6t-torch-test", log_dir=tmp_path)
    assert lg2 is lg1 and len(lg2.handlers) == n
    lg1.info("hello file")
    assert any(tmp_path.glob("*.log"))


# ----------------------------------------------------- broadcast frames
class TestBroadcastEncryption:
    """Crypto-gated like the Bonawitz tests; one 2048-bit keypair would be
    faster but the production KEY_BITS path is what must work."""

    @pytest.fixture(scope="class")
    def pair(self, tmp_path_factory):
        pytest.importorskip("cryptography")
        from vantage6_tpu_torch.common.encryption import RSACryptor

        d = tmp_path_factory.mktemp("wire_rsa")
        return RSACryptor(d / "a.pem"), RSACryptor(d / "b.pem")

    def test_binary_frame_roundtrip(self, pair):
        a, b = pair
        data = b"weights " * 1000
        frame = a.encrypt_bytes(data, b.public_key_str)
        assert frame[:5] == b"V6TE\x02"
        assert b.decrypt_bytes(frame) == data
        # string transport: base64(frame), no '$'
        wire = a.encrypt_bytes_to_str(data, b.public_key_str)
        assert "$" not in wire
        assert b.decrypt_str_to_bytes(wire) == data

    def test_large_payload_roundtrip(self, pair):
        # >=32 MB through the full RSA+AES path (satellite requirement)
        a, b = pair
        data = np.random.default_rng(0).integers(
            0, 256, 32 * 1024 * 1024 + 17, dtype=np.uint8
        ).tobytes()
        assert len(data) >= 32 * 1024 * 1024
        frame = a.encrypt_bytes(data, b.public_key_str)
        # binary framing: constant overhead, no base64 inflation
        assert len(frame) - len(data) < 1024
        assert b.decrypt_bytes(frame) == data

    def test_broadcast_single_aes_pass(self, pair):
        a, b = pair
        data = os.urandom(1 << 16)
        before = WIRE_STATS.snapshot()
        frames = a.encrypt_bytes_broadcast(
            data, [b.public_key_str, a.public_key_str, b.public_key_str]
        )
        after = WIRE_STATS.snapshot()
        assert len(frames) == 3
        # shared ciphertext: identical tails (nonce+ct), differing key seals
        tail = frames[0][-len(data) - 28:]
        assert all(f.endswith(tail[-len(data):]) for f in frames)
        assert b.decrypt_bytes(frames[0]) == data
        assert a.decrypt_bytes(frames[1]) == data
        assert b.decrypt_bytes(frames[2]) == data
        assert (after["broadcast_dedup_hits"]
                == before["broadcast_dedup_hits"] + 2)

    def test_broadcast_wrong_recipient_fails(self, pair):
        a, b = pair
        frames = a.encrypt_bytes_broadcast(b"secret", [b.public_key_str])
        with pytest.raises(Exception):
            a.decrypt_bytes(frames[0])

    def test_gcm_tamper_detected(self, pair):
        a, b = pair
        frame = bytearray(a.encrypt_bytes(b"secret", b.public_key_str))
        frame[-1] ^= 0xFF
        with pytest.raises(Exception):
            b.decrypt_bytes(bytes(frame))

    def test_malformed_blobs(self, pair):
        a, _ = pair
        for bad in ("notthreeparts", "QUJD", b"V6TE\x02\x00", b"V6TE\x02"):
            with pytest.raises(ValueError, match="malformed"):
                a.decrypt_bytes(bad)

    def test_cross_format_compat(self, pair):
        # v1 '$'-joined string blob decrypted by the v2-capable cryptor,
        # as str AND as ascii bytes (old DB columns read back as either)
        a, b = pair
        legacy = a._encrypt_legacy_str(b"old wire", b.public_key_str)
        assert "$" in legacy
        assert b.decrypt_bytes(legacy) == b"old wire"
        assert b.decrypt_str_to_bytes(legacy) == b"old wire"
        assert b.decrypt_bytes(legacy.encode("ascii")) == b"old wire"

    def test_env_pin_emits_legacy_strings(self, pair, monkeypatch):
        a, b = pair
        monkeypatch.setenv("V6T_WIRE_FORMAT", "v1")
        wire = a.encrypt_bytes_to_str(b"x", b.public_key_str)
        assert "$" in wire
        assert b.decrypt_str_to_bytes(wire) == b"x"

    def test_dummy_broadcast_shares_wire(self):
        from vantage6_tpu_torch.common.encryption import DummyCryptor

        d = DummyCryptor()
        frames = d.encrypt_bytes_broadcast(b"xyz", ["", "", ""])
        assert frames[0] is frames[1] is frames[2]  # zero copies
        wires = d.encrypt_bytes_to_str_broadcast(b"xyz", ["", ""])
        assert d.decrypt_str_to_bytes(wires[0]) == b"xyz"
        assert d.decrypt_bytes(d.encrypt_bytes(b"xyz")) == b"xyz"


# ------------------------------------------- the two packages' frames
JENC = importlib.import_module("vantage6_tpu.common.encryption")


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_frames_cross_between_the_packages(rsa_dir, rsa_pair, direction):
    """The keys are the module's PEM files: each package loads them, one
    encrypts to the other's public key, the other decrypts."""
    alice, bob = rsa_pair
    j_alice = JENC.RSACryptor(rsa_dir / "a.pem")
    j_bob = JENC.RSACryptor(rsa_dir / "b.pem")
    assert j_bob.public_key_str == bob.public_key_str
    sender, receiver = ((alice, j_bob) if direction == "port_to_jax"
                        else (j_alice, bob))
    data = np.random.default_rng(2).integers(
        0, 256, 1 << 16, dtype=np.uint8).tobytes()
    frame = sender.encrypt_bytes(data, receiver.public_key_str)
    assert frame[:5] == b"V6TE\x02"
    assert receiver.decrypt_bytes(frame) == data
    wire = sender.encrypt_bytes_to_str(data, receiver.public_key_str)
    assert receiver.decrypt_str_to_bytes(wire) == data
    legacy = sender._encrypt_legacy_str(b"old wire", receiver.public_key_str)
    assert receiver.decrypt_bytes(legacy) == b"old wire"
    frames = sender.encrypt_bytes_broadcast(
        data, [receiver.public_key_str, sender.public_key_str])
    assert receiver.decrypt_bytes(frames[0]) == data
    sig = sender.sign_bytes(b"advert")
    assert type(receiver).verify_signature(sender.public_key_str,
                                           b"advert", sig)


# --------------------------------------------------------------- rest
def test_rest_imports_without_requests_and_names_it(monkeypatch):
    from vantage6_tpu_torch.common import rest

    monkeypatch.setitem(sys.modules, "requests", None)
    with pytest.raises(RuntimeError, match="'requests' package"):
        rest.RestSession("http://127.0.0.1:9").request("GET", "health")
    with pytest.raises(RuntimeError, match="'requests' package"):
        rest.pooled_request("GET", "http://127.0.0.1:9/api/health")


class _Api(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server's naming
        page = int(self.path.rsplit("page=", 1)[-1].split("&")[0]) \
            if "page=" in self.path else 1
        body = {"data": [page], "pagination": {"total": 2}} \
            if self.path.startswith("/api/run") else {"status": "ok"}
        raw = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def log_message(self, *args):
        pass


def test_rest_session_round_trip_is_counted():
    pytest.importorskip("requests")
    from vantage6_tpu_torch.common.rest import POOL, REST_STATS, RestSession
    from vantage6_tpu_torch.common.telemetry import REGISTRY

    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Api)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        before = REST_STATS.snapshot()
        session = RestSession(f"http://127.0.0.1:{srv.server_port}")
        assert session.request("GET", "health") == {"status": "ok"}
        assert session.paginate("run") == [1, 2]
        after = REST_STATS.snapshot()
        snap = REGISTRY.snapshot()
    finally:
        srv.shutdown()
        srv.server_close()
        POOL.clear()
    assert after["calls"] == before["calls"] + 3
    assert after["bytes_received"] > before["bytes_received"]
    assert snap["v6t_rest_calls_total"] == after["calls"]


# ------------------------------------------------------- RSA identities
def test_federation_run_identity_signs_and_registry_verifies():
    pytest.importorskip("cryptography")
    from vantage6_tpu_torch.algorithm import data
    from vantage6_tpu_torch.algorithm.context import current_environment
    from vantage6_tpu_torch.runtime.federation import federation_from_datasets

    @data(1)
    def advert(d):
        env = current_environment()
        me = env.identity()
        registry = env.org_identities()
        mine = f"advert {env.metadata.node_id}".encode()
        sig = me.sign_bytes(mine)
        return {
            "own": RSACryptor.verify_signature(
                registry[env.metadata.node_id], mine, sig),
            "other": RSACryptor.verify_signature(
                registry[1 - env.metadata.node_id], mine, sig),
            "key": me.public_key_str,
        }

    fed = federation_from_datasets([{"x": np.zeros(1)}] * 2,
                                   {"img": {"advert": advert}},
                                   executor_workers=0, device="cpu")
    try:
        task = fed.create_task("img", {"method": "advert"})
        res = fed.wait_for_results(task.id)
    finally:
        fed.close()
    assert [r["own"] for r in res] == [True, True]
    assert [r["other"] for r in res] == [False, False]
    assert res[0]["key"] != res[1]["key"]
    assert fed._org_identity_registry() == {0: res[0]["key"],
                                            1: res[1]["key"]}
