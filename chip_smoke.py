#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check its kernels.

    python3 chip_smoke.py            # from the repository root; one card
    python3 chip_smoke.py --profile  # also trace one round (torch.profiler)

Phases, each of which raises (exit code 1) on failure:

1. build every hand-written kernel from ``vantage6_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, all at once) and print ptxas's register,
   spill and shared-memory report;
2. each kernel against its plain PyTorch version on the card, at the
   kernel's own tiles: the CUDA-core kernel in f32 and bf16, the
   tensor-core kernel in bf16 at every head dim it takes, causal and not,
   Tq and Tk off its tiles, Tq != Tk, ring-hop offsets that leave tiles
   partly visible, fully masked rows (exact zeros); each error beside its
   tolerance;
3. gradients through the autograd wrapper against the dense reference;
4. the slice at full width: the federated transformer round of the JAX
   package's benchmark model (d_model 1024, 8 layers, 8 heads, seq 1024,
   batch 16, vocab 4096, bf16, 4 stations, flash attention) for 8 rounds
   through ``make_engine``/``init``/``shard_tokens``/``round``, one round
   with station 3 masked out; the loss must be finite and fall, the
   tensor-core kernel must have launched rounds x stations x layers times
   and the CUDA-core kernel never, and a round with the
   plain ``recompute`` attention from the same state must give the same
   loss within a bf16 tolerance;
5. times on the card: ms per round, tokens/s, and at the main path's
   shape both kernels' ms per launch on the same tensors (CUDA-core, then
   tensor-core, twice each in turns), their plain versions', the bound,
   and ``scaled_dot_product_attention`` as a yardstick (the port never
   calls it).

``--profile`` traces one more round and reports device time by kernel
group and under the ``attention_fwd``/``attention_bwd`` profiler ranges.

Prints the card's name and power limit first, a ``{"kernels": [...]}`` line
before the last, and ``{"ok": true, "device": {...}}`` as the last line.
Without a CUDA device it exits 1 and prints no result. A copy of the
results is written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (dense), for the bound
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

F32_TOL = 2e-5  # the JAX suite's forward tolerance
GRAD_TOL = 3e-5  # the JAX suite's gradient tolerance
# bf16 outputs of O(1): 2 ulps of 2^-8 (a different f32 summation order in
# the kernel can move one rounding of p or of the output)
BF16_TOL = 2 * 2.0**-8
# the mean loss over 4 x 16 x 1024 tokens in bf16 compute, flash kernel vs
# plain blockwise attention: one bf16 ulp of relative difference
LOSS_RTOL = 2.0**-8

# the JAX package's benchmark transformer (bench.py TF_* and FO_STATIONS)
FULL = dict(d_model=1024, n_layers=8, n_heads=8, seq=1024, batch=16,
            vocab=4096, stations=4)
ROUNDS = 8
DROP_ROUND = 2  # station 3 is masked out in this round


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def attention_bound(b, h, t_q, t_k, d, q_offset, k_offset, causal,
                    elem_bytes, peak_flops):
    """(bound_ms, bound_by): the larger of the bytes q, k, v, o must move
    over the memory rate and the operations the unmasked scores need
    (2*d for q.k and 2*d for p.v per visible pair) over the peak rate."""
    if causal:
        vis = sum(min(max(q_offset + i - k_offset + 1, 0), t_k)
                  for i in range(t_q))
    else:
        vis = t_q * t_k
    flops = 4.0 * d * vis * b * h
    nbytes = elem_bytes * b * h * d * (2 * t_q + 2 * t_k)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")


def compare(fa, torch, out, q, k, v, qo, ko, causal, scale, variant, tol):
    """Max abs error of a kernel's output against its plain version at the
    kernel's tiles, checked against tol + tol * max|plain|."""
    spec = fa.KERNELS[variant]
    plain = fa.kernel_reference(q, k, v, qo, ko, causal, scale,
                                spec.block_q, spec.block_k)
    torch.cuda.synchronize()
    check(out.shape == q.shape and out.dtype == q.dtype, "kernel output shape")
    check(bool(torch.isfinite(out.float()).all()), "non-finite output")
    err = (out.float() - plain.float()).abs().max().item()
    lim = tol + tol * plain.float().abs().max().item()
    check(err <= lim, f"{variant} kernel disagrees with its plain version: "
          f"{err} > {lim}")
    return err, lim


def phase_kernel_vs_plain(fa, torch, dev):
    """Each kernel against its plain version at the kernel's own tiles."""
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [
        # dtype, causal, B, H, Tq, Tk, D, q_offset, k_offset
        ("f32", False, 2, 4, 96, 96, 64, 0, 0),
        ("f32", True, 2, 4, 96, 96, 64, 0, 0),
        ("f32", True, 1, 2, 1024, 1024, 128, 0, 0),
        ("f32", False, 1, 2, 1024, 1024, 32, 0, 0),
        ("f32", True, 2, 2, 100, 228, 16, 128, 0),  # ring hop, ragged
        ("f32", True, 1, 3, 256, 512, 8, 256, 0),  # ring hop, Tq != Tk
        ("bf16", False, 2, 4, 96, 96, 128, 0, 0),
        ("bf16", True, 2, 4, 96, 96, 16, 0, 0),
        ("bf16", True, 1, 2, 1024, 1024, 64, 0, 0),
        ("bf16", False, 1, 2, 1024, 1024, 128, 0, 0),
        ("bf16", True, 2, 2, 100, 228, 32, 128, 0),
        ("bf16", True, 1, 3, 256, 512, 8, 256, 0),
    ]
    # the tensor-core kernel at its edges (tiles 128 x 64), each head dim
    for d in fa.KERNELS["tensor_core"].head_dims:
        cases += [
            ("bf16", True, 1, 3, 200, 200, d, 0, 0),  # Tq, Tk off the tiles
            ("bf16", False, 1, 2, 130, 70, d, 0, 0),  # Tq != Tk, ragged
            ("bf16", True, 2, 2, 150, 333, d, 183, 0),  # ring hop
            # keys ahead of queries: rows before 90 fully masked, the rest
            # see a partly visible tile
            ("bf16", True, 1, 2, 257, 100, d, 37, 90),
        ]
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst = dict.fromkeys(fa.KERNELS, 0.0)
    for name, causal, b, h, t_q, t_k, d, qo, ko in cases:
        dt = dtypes[name]
        q = torch.randn(b, h, t_q, d, generator=g, device=dev).to(dt)
        k = torch.randn(b, h, t_k, d, generator=g, device=dev).to(dt)
        v = torch.randn(b, h, t_k, d, generator=g, device=dev).to(dt)
        scale = d**-0.5
        tol = F32_TOL if name == "f32" else BF16_TOL
        # the variant the dispatch picks, and the CUDA-core kernel beside it
        variants = {fa.kernel_variant(dt, d), "cuda_core"}
        for variant in sorted(variants):
            out = fa.flash_forward_cuda(q, k, v, qo, ko, causal, scale,
                                        variant=variant)
            err, lim = compare(fa, torch, out, q, k, v, qo, ko, causal,
                               scale, variant, tol)
            print(f"{variant} vs plain {name} causal={causal} "
                  f"[{b},{h},{t_q}x{t_k},{d}] off=({qo},{ko}): "
                  f"max_abs_err {err:.3e} tol {lim:.3e}")
            worst[variant] = max(worst[variant], err)
    # fully masked: every query precedes every key -> exact zeros
    for variant, spec in fa.KERNELS.items():
        for dt in spec.dtypes:
            for d in spec.head_dims:
                q = torch.randn(1, 2, 200, d, generator=g, device=dev).to(dt)
                out = fa.flash_forward_cuda(q, q, q, 0, 1000, True, 0.125,
                                            variant=variant)
                torch.cuda.synchronize()
                check(bool((out == 0).all()),
                      f"{variant}: fully masked rows are not exact zeros")
    print("kernels fully masked (k_offset=1000), every dtype and head dim: "
          "exact zeros")
    return worst


def phase_gradients(fa, torch, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    for t_q, t_k, qo, ko, causal in [(96, 96, 0, 0, True),
                                      (96, 96, 0, 0, False),
                                      (64, 160, 96, 0, True)]:
        qkv = [torch.randn(2, 4, t, 64, generator=g, device=dev)
               .requires_grad_() for t in (t_q, t_k, t_k)]
        before = fa.flash_forward_cuda.launches
        out = fa.flash_attention(*qkv, q_offset=qo, k_offset=ko,
                                 causal=causal)
        check(fa.flash_forward_cuda.launches == before + 1,
              "flash_attention did not launch the kernel")
        grads = torch.autograd.grad(torch.sin(out).sum(), qkv)
        ref = fa.reference(*qkv, q_offset=qo, k_offset=ko, causal=causal)
        ref_grads = torch.autograd.grad(torch.sin(ref).sum(), qkv)
        for name, a, r in zip("qkv", grads, ref_grads):
            err = (a - r).abs().max().item()
            lim = GRAD_TOL + GRAD_TOL * r.abs().max().item()
            print(f"grad d{name} f32 causal={causal} {t_q}x{t_k} "
                  f"off=({qo},{ko}): max_abs_err {err:.3e} tol {lim:.3e}")
            check(err <= lim, f"gradient d{name} disagrees: {err}")


def phase_slice(fa, ft, torch, dev):
    cfg = ft.TransformerConfig(
        vocab=FULL["vocab"], d_model=FULL["d_model"],
        n_heads=FULL["n_heads"], n_layers=FULL["n_layers"],
        max_len=FULL["seq"], dtype=torch.bfloat16, attention="flash",
    )
    n_s = FULL["stations"]
    eng = ft.make_engine(n_stations=n_s, seq_devices=1, cfg=cfg, lr=1e-3)
    check(eng.device.type == "cuda", "engine is not on the card")
    tokens = eng.shard_tokens(ft.make_federated_tokens(
        n_s, batch=FULL["batch"], seq_len=FULL["seq"], vocab=FULL["vocab"],
    ))
    params, opt = eng.init(torch.Generator().manual_seed(0))
    full = torch.ones(n_s)
    drop = torch.tensor([1.0] * (n_s - 1) + [0.0])

    # the main path's counts start here
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    losses, secs = [], []
    state = None
    for r in range(ROUNDS):
        if r == ROUNDS - 1:
            state = (params, opt)  # the recompute round starts from here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = eng.round(params, opt, tokens,
                                      drop if r == DROP_ROUND else full)
        loss = loss.item()  # waits for the round
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"round {r} mask={'drop3' if r == DROP_ROUND else 'all'} "
              f"loss {loss:.6f} {1e3 * secs[-1]:.1f} ms")
    launches = dict(fa.flash_forward_cuda.variant_launches)
    expect = ROUNDS * n_s * cfg.n_layers
    print(f"flash kernel launches on the main path: {launches} "
          f"(rounds x stations x layers = {expect})")
    check(launches["tensor_core"] == expect,
          "the main path did not run the tensor-core kernel")
    check(launches["cuda_core"] == 0,
          "the main path ran the CUDA-core kernel")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in
              [params["embed"], params["pos"]]
              + [w for layer in params["layers"] for w in layer.values()]),
          "non-finite parameters")

    rc_eng = ft.make_engine(
        n_stations=n_s, seq_devices=1,
        cfg=dataclasses.replace(cfg, attention="recompute"), lr=1e-3,
    )
    _, _, rc_loss = rc_eng.round(state[0], state[1], tokens, full)
    rc_loss = rc_loss.item()
    rel = abs(rc_loss - losses[-1]) / abs(rc_loss)
    print(f"loss from the same state: flash {losses[-1]:.6f} "
          f"recompute {rc_loss:.6f} rel diff {rel:.3e} tol {LOSS_RTOL:.3e}")
    check(rel <= LOSS_RTOL, "flash and plain attention rounds disagree")
    check(fa.flash_forward_cuda.launches == expect,
          "the plain round launched a kernel")

    steady = secs[1:]  # round 0 carries one-time set-up (cuBLAS, build)
    ms = 1e3 * sum(steady) / len(steady)
    tokens_per_round = n_s * FULL["batch"] * FULL["seq"]
    return dict(
        config=dict(FULL, dtype="bfloat16", attention="flash", lr=1e-3),
        rounds=ROUNDS, losses=losses, first_round_ms=1e3 * secs[0],
        ms_per_round=ms, round_ms=[1e3 * s for s in secs],
        tokens_per_s=tokens_per_round / (ms / 1e3),
        launches=launches, launches_per_round=n_s * cfg.n_layers,
        recompute_loss=rc_loss, loss_rel_diff=rel,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    ), (eng, params, opt, tokens, full)


def phase_times(fa, torch, dev):
    """Both kernels at the main path's shape, [16, 8, 1024, 128] bf16
    causal, on the same tensors: the CUDA-core kernel (before) and the
    tensor-core kernel (after), timed in turns."""
    b, h, t, d = FULL["batch"], FULL["n_heads"], FULL["seq"], \
        FULL["d_model"] // FULL["n_heads"]
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(b, h, t, d, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    scale = d**-0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True, scale=scale),
                         20)
    bound_ms, bound_by = attention_bound(b, h, t, t, d, 0, 0, True, 2,
                                         PEAK_BF16_FLOPS)
    res = {}
    for variant, spec in fa.KERNELS.items():
        out = fa.flash_forward_cuda(q, k, v, 0, 0, True, scale,
                                    variant=variant)
        err, lim = compare(fa, torch, out, q, k, v, 0, 0, True, scale,
                           variant, BF16_TOL)
        print(f"{variant} vs plain at the main path's shape [{b},{h},{t},{d}] "
              f"bf16 causal: max_abs_err {err:.3e} tol {lim:.3e}")
        plain_ms = cuda_ms(
            lambda: fa.kernel_reference(q, k, v, 0, 0, True, scale,
                                        spec.block_q, spec.block_k),
            3, warmup=1)
        res[variant] = dict(max_abs_err=err, ms=[], plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
    for variant in ("cuda_core", "tensor_core", "tensor_core", "cuda_core"):
        res[variant]["ms"].append(cuda_ms(
            lambda: fa.flash_forward_cuda(q, k, v, 0, 0, True, scale,
                                          variant=variant), 20))
    for variant, r in res.items():
        r["ms_runs"], r["ms"] = r["ms"], sum(r["ms"]) / len(r["ms"])
        print(f"flash_attention_fwd {variant} [{b},{h},{t},{d}] bf16 causal: "
              f"kernel {r['ms']:.4f} ms (runs {r['ms_runs'][0]:.4f}, "
              f"{r['ms_runs'][1]:.4f}), plain {r['plain_ms']:.4f} ms, sdpa "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return res


def phase_profile(ft, torch, eng_state):
    """One traced round: device time by kernel and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    eng, params, opt, tokens, mask = eng_state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.round(params, opt, tokens, mask)[2].item()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ranges = ("attention_fwd", "attention_bwd")
    rows = []  # (device ms, launches, kernel name): device events only
    kernel_ms = dict.fromkeys(ranges, 0.0)  # kernels launched in a range
    span_ms = dict.fromkeys(ranges, 0.0)  # the range's span on the device
    for ev in prof.key_averages():
        on_device = ev.device_type == torch.autograd.DeviceType.CUDA
        if ev.key in ranges:
            # a range is a CPU event and also a device-timeline annotation;
            # neither is a kernel
            if on_device:
                span_ms[ev.key] += ev.device_time_total / 1e3
            else:
                kernel_ms[ev.key] += ev.device_time_total / 1e3
        elif on_device:
            rows.append((ev.self_device_time_total / 1e3, ev.count, ev.key))
    check(bool(rows), "the profiler recorded no device time")
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)

    def kind(name):
        if "flash_fwd_wgmma_kernel" in name:
            return "flash kernel, tensor cores (attention forward)"
        if "flash_fwd_kernel" in name:
            return "flash kernel, CUDA cores (attention forward)"
        if "f32f32" in name:
            return "f32 GEMM (plain attention backward)"
        if "gemm" in name or "nvjet" in name or "xmma" in name:
            return "other GEMM (bf16 model matmuls)"
        return "elementwise and reductions"

    groups: dict[str, float] = {}
    for ms, _, name in rows:
        groups[kind(name)] = groups.get(kind(name), 0.0) + ms
    print(f"profiled round: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for name, ms in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f}%  {name}")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.2f} ms {n:6d}x {key[:90]}")
    # the profiler attributes a kernel to a range through PyTorch's launch;
    # a kernel launched through ctypes (the flash kernels) is seen only in
    # the range's span, here the kernel alone
    for name in ranges:
        print(f"  range {name}: PyTorch-launched kernels "
              f"{kernel_ms[name]:9.2f} ms "
              f"({100 * kernel_ms[name] / busy_ms:5.1f}% of busy), span on "
              f"the device {span_ms[name]:9.2f} ms")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, groups=groups,
                range_kernel_ms=kernel_ms, range_span_ms=span_ms,
                top=[dict(ms=m, count=n, name=k) for m, n, k in rows[:40]])


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from vantage6_tpu_torch.ops import _build
    from vantage6_tpu_torch.ops import flash_attention as fa
    from vantage6_tpu_torch.workloads import fed_transformer as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    build_s = _build.build_all()
    for name, s in build_s.items():
        print(f"build {name}: {s:.1f} s")
        for line in _build.build_log(name).splitlines():
            fn = re.search(r"Function properties for \S*?(flash_fwd_\w+?E)",
                           line)
            if fn:
                print(f"  {fn.group(1)}")
            elif any(w in line for w in ("registers", "spill", "smem",
                                         "Performance Loss")):
                print(f"    {line.strip()[:150]}")

    max_err_cases = phase_kernel_vs_plain(fa, torch, dev)
    phase_gradients(fa, torch, dev)
    slice_res, eng_state = phase_slice(fa, ft, torch, dev)
    print(f"slice: {slice_res['ms_per_round']:.1f} ms/round, "
          f"{slice_res['tokens_per_s']:.0f} tokens/s on {card}")
    prof = phase_profile(ft, torch, eng_state) if "--profile" in argv else None
    del eng_state
    times = phase_times(fa, torch, dev)

    names = {"tensor_core": "flash_attention_fwd_tc",
             "cuda_core": "flash_attention_fwd"}
    kernels = [dict(
        name=names[variant], variant=variant, route="cuda",
        source="vantage6_tpu_torch/ops/csrc/"
               + _build.SOURCES[fa.KERNELS[variant].library],
        replaces="vantage6_tpu/ops/flash_attention.py:31",
        launches=slice_res["launches"][variant],
        max_abs_err=times[variant]["max_abs_err"], ms=times[variant]["ms"],
        plain_ms=times[variant]["plain_ms"],
        bound_ms=times[variant]["bound_ms"],
        bound_by=times[variant]["bound_by"],
        library_ms=times[variant]["library_ms"],
    ) for variant in names]
    result = dict(card=card, kind=kind, build_s=build_s,
                  max_abs_err_cases=max_err_cases, slice=slice_res,
                  kernels=kernels, profile=prof,
                  seconds=time.perf_counter() - t_start)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"slice": slice_res}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
