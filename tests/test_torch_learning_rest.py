"""``/api/rounds`` on the port's server: the learning-plane histories of
``runtime.learning.LEARNING`` served per task (index, one task, 404, the
``limit`` parameter).

The port's copy of ``tests/test_learning.py``'s ``TestRoundsApi``, which
waited for the server.
"""
import numpy as np
import pytest

from vantage6_tpu_torch.runtime.learning import LEARNING, update_stats_host


@pytest.fixture(autouse=True)
def _clean_learning():
    LEARNING.clear()
    yield
    LEARNING.clear()



class TestRoundsApi:
    @pytest.fixture()
    def server(self):
        from vantage6_tpu_torch.client import UserClient
        from vantage6_tpu_torch.server.app import ServerApp

        srv = ServerApp()
        srv.ensure_root(password="rootpass123")
        http = srv.serve(port=0, background=True)
        client = UserClient(http.url)
        client.authenticate("root", "rootpass123")
        yield client
        http.stop()
        srv.close()

    def test_rounds_index_and_task(self, server):
        h = LEARNING.history(31)
        for i in range(3):
            h.record_stats(update_stats_host(
                np.eye(3, 5, dtype=np.float32) * (3 - i)
            ), loss=1.0 - 0.2 * i)
        idx = server.util.rounds()
        assert any(t["task"] == 31 for t in idx["tasks"])
        out = server.util.rounds(31)
        assert out["task_id"] == 31
        assert len(out["rounds"]) == 3
        assert out["summary"]["rounds"] == 3
        assert out["rounds"][-1]["loss"] == pytest.approx(0.6)

    def test_rounds_404_for_unknown_task(self, server):
        from vantage6_tpu_torch.client.client import ClientError

        with pytest.raises(ClientError) as e:
            server.util.rounds(424242)
        assert e.value.status == 404

    def test_rounds_limit_param(self, server):
        h = LEARNING.history(32)
        for i in range(10):
            h.record(update_norm=1.0, station_norms=[1], station_cos=[1])
        out = server.parent_request_limit = server.request(
            "GET", "rounds/32", params={"limit": 4}
        )
        assert len(out["rounds"]) == 4
