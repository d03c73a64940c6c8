"""``runtime/metrics.py::rest_stats_snapshot``: the same REST calls against
a local port server, made through each package's ``RestSession``, move
each package's ``REST_STATS`` snapshot the same way: the same keys, calls,
errors and bytes sent."""
import importlib

import pytest

pytest.importorskip("requests")

PKGS = ("vantage6_tpu", "vantage6_tpu_torch")


def _calls(pkg, url):
    rest = importlib.import_module(f"{pkg}.common.rest")
    metrics = importlib.import_module(f"{pkg}.runtime.metrics")
    before = metrics.rest_stats_snapshot()
    token = {}
    s = rest.RestSession(url, token_getter=lambda: token.get("t"))
    s.request("GET", "health")
    token["t"] = s.request("POST", "token/user", json_body={
        "username": "root", "password": "rootpass123"})["access_token"]
    s.request("POST", "organization", json_body={"name": f"org-{pkg}"})
    s.request("GET", "organization")
    with pytest.raises(rest.RestError):
        s.request("GET", "organization/999999")
    after = metrics.rest_stats_snapshot()
    assert after is not before and set(after) == set(before)
    return {k: after[k] - before[k] for k in after}


def test_rest_stats_snapshot_matches_the_reference():
    from vantage6_tpu_torch.server.app import ServerApp

    srv = ServerApp()
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    try:
        jax_delta, port_delta = (_calls(pkg, http.url)
                                 for pkg in PKGS)
    finally:
        http.stop()
        srv.close()
    assert set(port_delta) == set(jax_delta) == {
        "calls", "errors", "stale_retries", "bytes_sent", "bytes_received",
        "seconds"}
    assert port_delta["calls"] == jax_delta["calls"] == 5
    assert port_delta["errors"] == jax_delta["errors"] == 1
    assert port_delta["stale_retries"] == jax_delta["stale_retries"] == 0
    # the organization names differ by the package's name alone
    assert (port_delta["bytes_sent"] - jax_delta["bytes_sent"]
            == len("vantage6_tpu_torch") - len("vantage6_tpu"))
    assert port_delta["bytes_received"] > 0 and port_delta["seconds"] > 0
