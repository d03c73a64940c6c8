"""The FLOP and byte arithmetic and the trace reductions, against values
worked by hand."""
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from portbench import cells, roofline, trace  # noqa: E402

GPT2 = cells.resolve("gpt2-medium.ctx1024")
GPT2_128 = cells.resolve("gpt2-medium.ctx128")
CNN = cells.resolve("cnn-flagship.dense")
PEAK = cells.peaks("NVIDIA H100 80GB HBM3")


def test_gpt2_medium_round_flops():
    f = cells.flops(GPT2)
    # 3 x (24 x (24 x 1024^2 + 2 x 1024 x 1025) + 2 x 1024 x 50257)
    #   x 4 x 8 x 1024 tokens
    per_token = 24 * (24 * 1024**2 + 2 * 1024 * 1025) + 2 * 1024 * 50257
    assert per_token == 757_286_912
    assert f.round_flops(GPT2.config, GPT2.traffic) == 3 * per_token * 32768
    assert f.round_flops(GPT2.config, GPT2.traffic) == pytest.approx(
        7.45e13, rel=1e-3)
    assert f.round_flops(GPT2_128.config, GPT2_128.traffic) == \
        pytest.approx(7.01e13, rel=1e-3)


def test_cnn_round_flops():
    f = cells.flops(CNN)
    # conv 28*28*32*9*2 + conv 14*14*64*288*2 + 3136*128*2 + 128*10*2
    assert f.forward_flops(CNN.config["model"]) == 8_482_304
    assert f.round_flops(CNN.config, CNN.traffic) == \
        3 * 8_482_304 * 32 * 10 * 32
    assert f.round_flops(CNN.config, CNN.traffic) == pytest.approx(
        2.6e11, rel=3e-3)


def test_attention_work_and_bounds():
    f = cells.flops(GPT2)
    fwd = f.attention_fwd(GPT2.config, GPT2.traffic)
    bwd = f.attention_bwd(GPT2.config, GPT2.traffic)
    pairs = 8 * 16 * 1024 * 1025 / 2  # B x H x T (T + 1) / 2
    assert fwd["flops"] == 4 * 64 * pairs and bwd["flops"] == 10 * 64 * pairs
    values = 8 * 16 * 1024 * 64
    assert fwd["bytes"] == 4 * values * 2 and bwd["bytes"] == 8 * values * 2
    # forward: 1.72e10 FLOPs / 989e12 = 17.4 us against 67.1 MB /
    # 3.35e12 = 20.0 us, bound by its bytes
    t, bound = roofline.least_seconds(fwd, PEAK)
    assert bound == "bytes" and t == pytest.approx(67.1e6 / 3.35e12,
                                                   rel=1e-3)
    # backward: 4.30e10 FLOPs = 43.5 us against 134.2 MB = 40.1 us
    t, bound = roofline.least_seconds(bwd, PEAK)
    assert bound == "flops" and t == pytest.approx(4.2994e10 / 989e12,
                                                   rel=1e-3)
    # at 128 tokens both are bound by their bytes
    for work in (f.attention_fwd, f.attention_bwd):
        small = work(GPT2_128.config, GPT2_128.traffic)
        assert roofline.least_seconds(small, PEAK)[1] == "bytes"


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _trace():
    events = [
        _ev("user_annotation", trace.WINDOW_RANGE, 0, 100),
        _ev("user_annotation", "attention_fwd", 10, 10, tid=1),
        _ev("user_annotation", "attention_bwd", 50, 10, tid=2),
        _ev("cpu_op", "aten::mm", 30, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 52, 1, tid=2, correlation=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 55, 1, tid=1, correlation=4),
        _ev("kernel", "flash", 14, 6, correlation=1),
        _ev("kernel", "gemm", 18, 12, correlation=2),
        _ev("kernel", "bwd", 60, 20, correlation=3),
        _ev("gpu_memcpy", "copy", 79, 6, correlation=4),
    ]
    return trace.parse(events, rounds=2)


def test_trace_reductions():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    # busy: [14, 30] and [60, 85]
    assert tr.busy_s() == pytest.approx(41e-6)
    assert tr.under_range("attention_fwd") == (1, pytest.approx(6e-6))
    # the copy launched at 55 on thread 1 is not under thread 2's range
    assert tr.under_range("attention_bwd") == (1, pytest.approx(20e-6))
    assert tr.under_range("nothing") == (0, 0.0)
    ops = dict(tr.top_device_ops())
    assert ops["bwd"] == pytest.approx(20e-6)
    gaps = dict(tr.idle_gaps())
    # [0, 14] and [85, 100] under no op, [30, 60] mid 45 under no op but
    # ... the mm op covers 30-35 only
    assert sum(gaps.values()) == pytest.approx(59e-6)


def test_readers_on_a_trace():
    tr = _trace()
    ctx = types.SimpleNamespace(trace=tr, round_s=25e-6, config=GPT2.config,
                                traffic=GPT2.traffic, flops=cells.flops(GPT2),
                                peak=PEAK)
    # 41 us busy over the 2 traced rounds, against 25 us a round untraced
    idle = cells.reader("layer_metrics", "device_idle_pct").read(ctx)
    assert idle == pytest.approx(100 * (1 - 20.5 / 25))
    mfu = cells.reader("layer_metrics", "mfu").read(ctx)
    assert mfu == pytest.approx(100 * 7.4444332597248e13 / 989e12 / 25e-6)
    fwd = cells.reader("layer_metrics", "attn_fwd_roofline_pct").read(ctx)
    least = roofline.least_seconds(
        ctx.flops.attention_fwd(GPT2.config, GPT2.traffic), PEAK)[0]
    assert fwd == pytest.approx(100 * least / 6e-6)
    ctx.peak = None  # a card the table lacks: the rooflines read nothing
    assert cells.reader("layer_metrics", "attn_fwd_roofline_pct").read(
        ctx) is None
    ctx.flops = cells.flops(CNN)  # no attention in the CNN
    ctx.peak = PEAK
    assert cells.reader("layer_metrics", "attn_bwd_roofline_pct").read(
        ctx) is None


def test_end_to_end_readers():
    win = types.SimpleNamespace(latencies=[0.01] * 19 + [0.05], window_s=0.24,
                                rounds=20, setup_s=3.5, peak_bytes=2**31)
    read = {m: cells.reader("end_to_end", m).read(win) for m in
            ("round_ms", "round_p95_ms", "peak_mem_gib", "setup_s")}
    assert read == {"round_ms": pytest.approx(12.0),
                    "round_p95_ms": pytest.approx(10.0),
                    "peak_mem_gib": 2.0, "setup_s": 3.5}
