#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check its kernels.

    python3 chip_smoke.py            # from the repository root; one card
    python3 chip_smoke.py --profile  # also trace a round of each run

Phases, each of which raises (exit code 1) on failure:

1. build every hand-written kernel from ``vantage6_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, all at once) and print ptxas's register,
   spill and shared-memory report;
2. each kernel against its plain PyTorch version on the card, at the
   kernel's own tiles: the CUDA-core kernel in f32 and bf16, the
   tensor-core kernel in bf16 and the TF32x3 kernel in f32, each at every
   head dim it takes, causal and not, Tq and Tk off its tiles, Tq != Tk,
   ring-hop offsets that leave tiles partly visible, keys ahead of queries,
   fully masked rows (exact zeros); each error beside its tolerance;
3. f32 gradients through the autograd wrapper, whose forward is the
   TF32x3 kernel, against the dense reference;
4. the slice at full width: the federated transformer round of the JAX
   package's benchmark model (d_model 1024, 8 layers, 8 heads, seq 1024,
   batch 16, vocab 4096, 4 stations, flash attention) for 8 rounds
   through ``make_engine``/``init``/``shard_tokens``/``round``, one round
   with station 3 masked out, twice: in bf16 compute (the main path) and
   in ``TransformerConfig``'s default f32. In each run the loss must be
   finite and fall, the kernel that serves the dtype (tensor-core for
   bf16, TF32x3 for f32) must have launched rounds x stations x layers
   times and no other kernel at all, and a round with the plain
   ``recompute`` attention from the same state must give the same loss
   within the dtype's tolerance;
5. times on the card: ms per round, tokens/s and peak memory of each run,
   and at the main path's shape each kernel's ms per launch beside the
   CUDA-core kernel's on the same tensors, in turns (bf16: tensor-core;
   f32: TF32x3), their plain versions', the bound, and
   ``scaled_dot_product_attention`` in the same dtype as a yardstick (the
   port never calls it).

``--profile`` traces one more round of each run of phase 4
(torch.profiler) and reports device time by kernel group and under the
``attention_fwd``/``attention_bwd`` profiler ranges.

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
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
TF32_PASSES = 3  # the TF32x3 kernel's passes per product

F32_TOL = 2e-5  # the JAX suite's forward tolerance
GRAD_TOL = 3e-5  # the JAX suite's gradient tolerance
# bf16 outputs of O(1): 2 ulps of 2^-8 (a different f32 summation order in
# the kernel can move one rounding of p or of the output)
BF16_TOL = 2 * 2.0**-8
# the mean loss over 4 x 16 x 1024 tokens in bf16 compute, flash kernel vs
# plain blockwise attention: one bf16 ulp of relative difference
LOSS_RTOL = 2.0**-8
# the same in f32 compute: the two attentions differ by f32 rounding (the
# kernel is held to 2e-5 of its plain version and lands near 1e-6), which
# moves an O(1) mean loss far less than 2^-16
LOSS_RTOL_F32 = 2.0**-16
# the kernel that serves each compute dtype at the slice's head dim 128
MAIN_VARIANT = {"bfloat16": "tensor_core", "float32": "tf32x3"}

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
    # the tensor-core (bf16) and TF32x3 (f32) kernels at their edges (tiles
    # 128 x 64), each head dim
    for name, variant in (("bf16", "tensor_core"), ("f32", "tf32x3")):
        for d in fa.KERNELS[variant].head_dims:
            cases += [
                (name, True, 1, 3, 200, 200, d, 0, 0),  # Tq, Tk off tiles
                (name, False, 1, 2, 130, 70, d, 0, 0),  # Tq != Tk, ragged
                (name, True, 2, 2, 150, 333, d, 183, 0),  # ring hop
                # keys ahead of queries: rows before 90 fully masked, the
                # rest see a partly visible tile
                (name, True, 1, 2, 257, 100, d, 37, 90),
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
        before = dict(fa.flash_forward_cuda.variant_launches)
        out = fa.flash_attention(*qkv, q_offset=qo, k_offset=ko,
                                 causal=causal)
        before["tf32x3"] += 1
        check(fa.flash_forward_cuda.variant_launches == before,
              "flash_attention in f32 did not launch the TF32x3 kernel")
        grads = torch.autograd.grad(torch.sin(out).sum(), qkv)
        ref = fa.reference(*qkv, q_offset=qo, k_offset=ko, causal=causal)
        ref_grads = torch.autograd.grad(torch.sin(ref).sum(), qkv)
        for name, a, r in zip("qkv", grads, ref_grads):
            err = (a - r).abs().max().item()
            lim = GRAD_TOL + GRAD_TOL * r.abs().max().item()
            print(f"grad d{name} f32 causal={causal} {t_q}x{t_k} "
                  f"off=({qo},{ko}): max_abs_err {err:.3e} tol {lim:.3e}")
            check(err <= lim, f"gradient d{name} disagrees: {err}")


def phase_slice(fa, ft, torch, dev, dtype=None):
    """The slice at full width for ROUNDS rounds; ``dtype`` is the compute
    dtype, None for ``TransformerConfig``'s default (f32)."""
    cfg = ft.TransformerConfig(
        vocab=FULL["vocab"], d_model=FULL["d_model"],
        n_heads=FULL["n_heads"], n_layers=FULL["n_layers"],
        max_len=FULL["seq"], attention="flash",
        **({} if dtype is None else {"dtype": dtype}),
    )
    dtype_name = str(cfg.dtype).removeprefix("torch.")
    variant = MAIN_VARIANT[dtype_name]
    check(fa.kernel_variant(cfg.dtype, cfg.head_dim) == variant,
          f"{dtype_name} attention is not served by the {variant} kernel")
    loss_rtol = LOSS_RTOL_F32 if cfg.dtype == torch.float32 else LOSS_RTOL
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
    torch.cuda.reset_peak_memory_stats()
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
        print(f"{dtype_name} round {r} "
              f"mask={'drop3' if r == DROP_ROUND else 'all'} "
              f"loss {loss:.6f} {1e3 * secs[-1]:.1f} ms")
    launches = dict(fa.flash_forward_cuda.variant_launches)
    peak_mem_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = ROUNDS * n_s * cfg.n_layers
    print(f"flash kernel launches in the {dtype_name} run: {launches} "
          f"(rounds x stations x layers = {expect})")
    check(launches[variant] == expect,
          f"the {dtype_name} run did not run the {variant} kernel")
    check(sum(launches.values()) == expect,
          f"the {dtype_name} run ran another kernel than {variant}")
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
    print(f"{dtype_name} loss from the same state: flash {losses[-1]:.6f} "
          f"recompute {rc_loss:.6f} rel diff {rel:.3e} tol {loss_rtol:.3e}")
    check(rel <= loss_rtol, "flash and plain attention rounds disagree")
    check(fa.flash_forward_cuda.launches == expect,
          "the plain round launched a kernel")

    steady = secs[1:]  # round 0 carries one-time set-up (cuBLAS, build)
    ms = 1e3 * sum(steady) / len(steady)
    tokens_per_round = n_s * FULL["batch"] * FULL["seq"]
    res = dict(
        config=dict(FULL, dtype=dtype_name, attention="flash", lr=1e-3),
        rounds=ROUNDS, losses=losses, first_round_ms=1e3 * secs[0],
        ms_per_round=ms, round_ms=[1e3 * s for s in secs],
        tokens_per_s=tokens_per_round / (ms / 1e3),
        launches=launches, launches_per_round=n_s * cfg.n_layers,
        recompute_loss=rc_loss, loss_rel_diff=rel, loss_rtol=loss_rtol,
        peak_mem_gb=peak_mem_gb,
    )
    print(f"{dtype_name} slice: {ms:.1f} ms/round, "
          f"{res['tokens_per_s']:.0f} tokens/s, peak {peak_mem_gb:.2f} GB")
    return res, (eng, params, opt, tokens, full)


def phase_times(fa, torch, dev):
    """Each tensor-core kernel at the main path's shape, [16, 8, 1024, 128]
    causal, in the dtype it serves, and the CUDA-core kernel (the kernel
    before it) on the same tensors, timed in turns: bf16 with the
    tensor-core kernel, f32 with the TF32x3 kernel. Returns
    {dtype: {variant: figures}}."""
    b, h, t, d = FULL["batch"], FULL["n_heads"], FULL["seq"], \
        FULL["d_model"] // FULL["n_heads"]
    g = torch.Generator(device=dev).manual_seed(2)
    scale = d**-0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {}
    for name, dtype, peak, tol in (
            ("bfloat16", torch.bfloat16, PEAK_BF16_FLOPS, BF16_TOL),
            ("float32", torch.float32, PEAK_TF32_FLOPS, F32_TOL)):
        new = MAIN_VARIANT[name]
        q, k, v = (torch.randn(b, h, t, d, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        library_ms = cuda_ms(
            lambda: sdpa(q, k, v, is_causal=True, scale=scale), 20)
        bound_ms, bound_by = attention_bound(b, h, t, t, d, 0, 0, True,
                                             q.element_size(), peak)
        group = {}
        for variant in ("cuda_core", new):
            spec = fa.KERNELS[variant]
            out = fa.flash_forward_cuda(q, k, v, 0, 0, True, scale,
                                        variant=variant)
            err, lim = compare(fa, torch, out, q, k, v, 0, 0, True, scale,
                               variant, tol)
            print(f"{variant} vs plain at the main path's shape "
                  f"[{b},{h},{t},{d}] {name} causal: max_abs_err {err:.3e} "
                  f"tol {lim:.3e}")
            plain_ms = cuda_ms(
                lambda: fa.kernel_reference(q, k, v, 0, 0, True, scale,
                                            spec.block_q, spec.block_k),
                3, warmup=1)
            group[variant] = dict(dtype=name, max_abs_err=err, ms=[],
                                  plain_ms=plain_ms, library_ms=library_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
        if dtype == torch.float32:
            # the least time of three TF32 passes at the TF32 peak
            group[new]["tf32x3_floor_ms"] = attention_bound(
                b, h, t, t, d, 0, 0, True, 4, peak / TF32_PASSES)[0]
        for variant in ("cuda_core", new, new, "cuda_core"):
            group[variant]["ms"].append(cuda_ms(
                lambda: fa.flash_forward_cuda(q, k, v, 0, 0, True, scale,
                                              variant=variant), 20))
        for variant, r in group.items():
            r["ms_runs"], r["ms"] = r["ms"], sum(r["ms"]) / len(r["ms"])
            floor = (f", 3xTF32 floor {r['tf32x3_floor_ms']:.4f} ms"
                     if "tf32x3_floor_ms" in r else "")
            print(f"flash_attention_fwd {variant} [{b},{h},{t},{d}] {name} "
                  f"causal: kernel {r['ms']:.4f} ms (runs "
                  f"{r['ms_runs'][0]:.4f}, {r['ms_runs'][1]:.4f}), plain "
                  f"{r['plain_ms']:.4f} ms, sdpa {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}){floor}")
        res[name] = group
    return res


def phase_profile(ft, torch, eng_state, run):
    """One traced round of the ``run`` run (a compute dtype): device time by kernel and the
    device's busy share."""
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
        if "flash_fwd_tf32x3_kernel" in name:
            return "flash kernel, tensor cores in 3xTF32 (attention forward)"
        if "flash_fwd_wgmma_kernel" in name:
            return "flash kernel, tensor cores (attention forward)"
        if "flash_fwd_kernel" in name:
            return "flash kernel, CUDA cores (attention forward)"
        if "f32f32" in name or "sgemm" in name:
            return "f32 GEMMs (attention backward; the model's too in f32)"
        if "gemm" in name or "nvjet" in name or "xmma" in name:
            return "bf16 GEMMs (model matmuls)"
        return "elementwise and reductions"

    groups: dict[str, float] = {}
    for ms, _, name in rows:
        groups[kind(name)] = groups.get(kind(name), 0.0) + ms
    print(f"profiled {run} round: wall {wall_ms:.1f} ms, device busy "
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
    print(card)
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
    slice_res, prof = {}, {}
    # the main path in bf16 compute, then the default dtype's, f32
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", None)):
        slice_res[name], eng_state = phase_slice(fa, ft, torch, dev, dtype)
        if "--profile" in argv:
            prof[name] = phase_profile(ft, torch, eng_state, name)
        del eng_state
    for name, r in slice_res.items():
        print(f"slice {name}: {r['ms_per_round']:.1f} ms/round, "
              f"{r['tokens_per_s']:.0f} tokens/s, peak "
              f"{r['peak_mem_gb']:.2f} GB on {card}")
    times = phase_times(fa, torch, dev)

    # each kernel in the dtype whose path it serves (the CUDA-core kernel,
    # which serves neither at head dim 128, beside the TF32x3 one in f32)
    names = {"tensor_core": ("flash_attention_fwd_tc", "bfloat16"),
             "tf32x3": ("flash_attention_fwd_tf32x3", "float32"),
             "cuda_core": ("flash_attention_fwd", "float32")}
    kernels = [dict(
        name=name, variant=variant, route="cuda",
        source="vantage6_tpu_torch/ops/csrc/"
               + _build.SOURCES[fa.KERNELS[variant].library],
        replaces="vantage6_tpu/ops/flash_attention.py:31",
        launches=sum(r["launches"][variant] for r in slice_res.values()),
        **{key: times[dtype][variant][key] for key in (
            "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    ) for variant, (name, dtype) in names.items()]
    result = dict(card=card, kind=kind, build_s=build_s,
                  max_abs_err_cases=max_err_cases, slice=slice_res,
                  kernels=kernels, times=times, profile=prof,
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
