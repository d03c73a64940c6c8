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
   port never calls it);
6. the flagship FedAvg-CNN at full size (the JAX package's benchmark
   config: 32 stations x 256 examples, Dirichlet 0.5, noise 2.0, 10 local
   steps of batch 32 at lr 0.05, server sgd(1.0), bf16 compute, 5 fused
   rounds) through ``make_engine``/``make_federated_data``/
   ``init_params``/``init``/``run_rounds``: a fresh 5-round run whose
   loss must fall and whose accuracy on the held-out set must pass 0.2;
   the warm-up and capture time of the CUDA graph, ms/round of the fused
   run (median of 3) and of ``round()`` driven eagerly, peak memory; no
   flash kernel may launch. Then the identities, with cuDNN's
   deterministic algorithms: fused == eager rounds from the same state and
   indices (exactly), a round (stations under vmap) == the mean of the
   stations' deltas taken one by one (bf16 tolerance), a masked round ==
   ``fed_mean`` over the other stations, ``async_round`` ==
   ``round(mask=accept * discount**staleness)`` (exactly), and
   ``learning_stats=True`` gives ``[5, 32]`` stats.

7. gradient compression on the flagship config of phase 6: a dense arm
   and a ``CompressorSpec(topk_ratio=0.1, int8=True)`` arm from one init,
   each a fresh 5-round fused run (accuracy on phase 6's held-out set,
   warm-up and capture seconds, peak memory) and fused ms/round (median
   of 3 chained runs); the on-wire reduction from ``compression_stats``
   (at least 4x), the accuracy gap (at most 0.08, bench.py's compression
   leg) and the compressed accuracy (above 0.2); one ``compress_stacked``
   call at ``[32, 421642]`` timed; then, with cuDNN deterministic:
   ``new_ef == acc - hat`` and ``decompress_flat(payload) == hat``
   exactly for one round on the card, a masked station's EF row
   unchanged, 5 fused rounds == 5 eager rounds from generators of one
   seed, and an identity spec and ``topk_ratio=1.0`` equal to dense,
   all exactly; no flash kernel may launch;
8. the analysis programs at a registry's size, each held on the host to
   a float64 numpy oracle with its tolerance, ms per call (median of 3,
   synchronised) and peak memory: correlation (f32, 32 stations x 65,536
   rows x 16 features, ragged) against ``np.corrcoef``; GLM (float64,
   the same rows with an intercept) for gaussian, binomial and poisson
   against numpy IRLS; crosstab (12 x 8 categories, ``min_cell_count``
   5) against exact pooled counts and the poisoning rule; quantiles 0.5
   and 0.95 (64 bisection steps) against the pooled rank value; vertical
   logistic regression (4 stations x 262,144 rows x 16 features, 100
   iterations) against numpy pooled gradient descent; ``secure_fed_mean``
   over one round's flagship CNN deltas (masks cancel exactly, within
   quantization error of ``fed_mean``) and over ``[32, 4096]`` KM-sized
   counts (exact), and the pair masks' Philox-4x32-10 against its
   published known answer on the card; no flash kernel may launch.

``--profile`` traces one more round of each run of phase 4
(torch.profiler) and reports device time by kernel group and under the
``attention_fwd``/``attention_bwd`` profiler ranges, one fused round of
phases 6 and 7 (dense and compressed) with the device's busy share, and
one call of each analysis program of phase 8 (kernel time, launches).

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

import numpy as np

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

# the JAX package's flagship FedAvg-CNN benchmark (bench.py N_STATIONS,
# N_PER_STATION, LOCAL_STEPS, BATCH, LR, SPMD_ROUNDS, SYNTH_NOISE,
# TIMED_RUNS; Dirichlet alpha 0.5; server sgd(1.0); bf16 compute)
FEDAVG = dict(stations=32, per_station=256, alpha=0.5, noise=2.0,
              local_steps=10, batch=32, lr=0.05, rounds=5, timed_runs=3)
# its held-out eval set (bench.py _eval_data): fresh synthetic draws
FEDAVG_EVAL = dict(n=2048, seed=777, noise=2.0)
FEDAVG_MIN_ACCURACY = 0.2  # twice chance on 10 classes


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


def median_ms(torch, fn, runs: int = 3, warmup: int = 1, per: int = 1):
    """(median ms, all ms, the last result) of ``runs`` calls of ``fn``
    after ``warmup`` untimed calls, each between two synchronisations, on
    the host clock, divided by ``per`` (the rounds one call runs)."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / per)
    return sorted(out)[runs // 2], out, result


def trace_device(torch, fn):
    """One call of ``fn`` under the profiler: (its wall ms, to a
    synchronisation, and the device's kernels as (ms, launches, name),
    the longest first)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    return wall_ms, sorted(rows, reverse=True)


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


def cnn_round_flops(cfg: dict) -> float:
    """bench.py's analytic FLOPs of one FedAvg-CNN round (all stations): 3x
    the forward's conv and dense multiply-adds, 2 FLOPs each."""
    fwd = (28 * 28 * 32 * 9 * 2 + 14 * 14 * 64 * 9 * 32 * 2
           + 7 * 7 * 64 * 128 * 2 + 128 * 10 * 2)
    return 3.0 * fwd * cfg["batch"] * cfg["local_steps"] * cfg["stations"]


def _max_diff(torch, a, b) -> float:
    from vantage6_tpu_torch._tree import tree_leaves

    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def phase_fedavg(fa, torch, dev):
    """The flagship FedAvg-CNN at full size through the port's entry points
    (make_engine -> make_federated_data -> init_params -> init ->
    run_rounds): times, accuracy and the identities the engine promises."""
    from vantage6_tpu_torch.fed.fedavg import WARMUP_ROUNDS
    from vantage6_tpu_torch.utils.datasets import synthetic_image_classes
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    cfg = FEDAVG
    n_s, k = cfg["stations"], cfg["rounds"]
    sync = torch.cuda.synchronize

    def engine(**kw):
        return W.make_engine(n_stations=n_s, device=dev,
                             local_steps=cfg["local_steps"],
                             batch_size=cfg["batch"], local_lr=cfg["lr"],
                             **kw)

    eng = engine(learning_stats=False)
    sx, sy, counts = W.make_federated_data(
        n_s, n_per_station=cfg["per_station"], alpha=cfg["alpha"], seed=0,
        mesh=eng.mesh, noise=cfg["noise"])
    params0 = W.init_params(1, device=dev)
    opt0 = eng.init(params0)
    gen = torch.Generator(device=dev).manual_seed(2)
    print(f"fedavg data: x {tuple(sx.shape)} counts min "
          f"{counts.min().item():.0f} max {counts.max().item():.0f}")

    # the main path's counts start here: a fresh run from the init, which
    # warms up, captures the round and replays it k times
    torch.cuda.reset_peak_memory_stats()
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    sync()
    t0 = time.perf_counter()
    params, opt, losses, _ = eng.run_rounds(params0, sx, sy, counts, gen, k,
                                            opt_state=opt0)
    losses = losses.tolist()
    first_s = time.perf_counter() - t0
    capture = eng.last_capture
    check(capture is not None, "run_rounds did not capture a CUDA graph")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"non-finite fedavg loss {losses}")
    check(losses[-1] < losses[0], f"fedavg loss did not fall: {losses}")
    ex, ey = synthetic_image_classes(FEDAVG_EVAL["n"], seed=FEDAVG_EVAL["seed"],
                                     noise=FEDAVG_EVAL["noise"])
    acc = W.evaluate(params, ex, ey)
    print(f"fedavg fresh {k}-round run: losses "
          f"{[round(x, 4) for x in losses]}, accuracy {acc:.4f} "
          f"({FEDAVG_EVAL['n']} eval examples)")
    check(acc > FEDAVG_MIN_ACCURACY, f"fedavg accuracy {acc} <= "
          f"{FEDAVG_MIN_ACCURACY}")

    # ms per round: the median over timed runs of k replayed rounds, each
    # run chained from the last
    state = [params, opt]

    def fused_run():
        state[:] = eng.run_rounds(*state[:1], sx, sy, counts, gen, k,
                                  opt_state=state[1])[:2]

    fused_ms, fused_runs, _ = median_ms(torch, fused_run, cfg["timed_runs"],
                                        warmup=0, per=k)
    state = [params, opt]

    def eager_round():
        state[:] = eng.round(*state, sx, sy, counts, gen)[:2]

    # k chained rounds after one that sets up
    eager_ms, eager, _ = median_ms(torch, eager_round, k)
    launches = dict(fa.flash_forward_cuda.variant_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(sum(launches.values()) == 0,
          f"the fedavg run launched a flash kernel: {launches}")

    flops = cnn_round_flops(cfg)
    res = dict(
        config=dict(cfg, compute="bfloat16", server="sgd(1.0)"),
        first_run_s=first_s, capture=capture, losses=losses,
        final_loss=losses[-1], accuracy=acc,
        fused_ms_per_round=fused_ms, fused_runs_ms=fused_runs,
        rounds_per_s=1e3 / fused_ms, eager_ms_per_round=eager_ms,
        eager_rounds_ms=eager, peak_mem_gb=peak_gb, launches=launches,
        flops_per_round=flops,
        flops_bound_ms=1e3 * flops / PEAK_BF16_FLOPS,
    )
    print(f"fedavg capture: warm-up {capture['warmup_s']:.3f} s "
          f"({WARMUP_ROUNDS} rounds), capture {capture['capture_s']:.3f} s")
    print(f"fedavg first run (warm-up + capture + {k} rounds): "
          f"{first_s:.3f} s")
    print(f"fedavg fused: {fused_ms:.3f} ms/round "
          f"({1e3 / fused_ms:.1f} rounds/s; runs {fused_runs}); eager "
          f"round(): {eager_ms:.3f} ms/round; peak {peak_gb:.3f} GB; "
          f"{flops / 1e9:.1f} GFLOP/round, bound "
          f"{res['flops_bound_ms']:.4f} ms at the bf16 peak")

    # the identities, on engines of their own with cuDNN's deterministic
    # algorithms, so that the same round gives the same bits twice
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gates = fedavg_gates(torch, engine, params0, sx, sy, counts, gen, k)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    res["gates"] = gates
    return res, (eng, params, opt, sx, sy, counts, gen)


def fedavg_gates(torch, engine, params0, sx, sy, counts, gen, k):
    """Checks every identity, then raises naming each that does not hold;
    returns the errors."""
    from vantage6_tpu_torch._tree import tree_leaves, tree_map
    from vantage6_tpu_torch.fed.collectives import fed_mean
    from vantage6_tpu_torch.fed.fedavg import AsyncRoundSpec

    n_s = counts.shape[0]
    failed = []

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    eng = engine(learning_stats=False)
    opt0 = eng.init(params0)
    idx = eng.draw_batch_indices(counts, gen, k)
    out = {}

    # k fused rounds == k eager round() calls, same state, same indices
    p, o, losses, _ = eng.run_rounds(params0, sx, sy, counts, None, k,
                                     opt_state=opt0, batch_idx=idx)
    q, r, eager_losses = params0, opt0, []
    for i in range(k):
        q, r, loss, _ = eng.round(q, r, sx, sy, counts, batch_idx=idx[i])
        eager_losses.append(loss)
    out["fused_vs_eager_params"] = _max_diff(torch, p, q)
    out["fused_vs_eager_loss"] = _max_diff(torch, losses,
                                           torch.stack(eager_losses))
    print(f"gate fused == eager ({k} rounds, injected indices): params "
          f"max_abs_err {out['fused_vs_eager_params']:.3e}, losses "
          f"{out['fused_vs_eager_loss']:.3e} (tolerance 0: the same kernels)")
    gate(out["fused_vs_eager_params"] == 0 and out["fused_vs_eager_loss"] == 0,
          "fused rounds differ from eager rounds")

    # a round (stations batched under vmap) == params0 + the mean of the
    # stations' deltas taken one by one (sgd(1.0)), one round
    a = eng.round(params0, opt0, sx, sy, counts, batch_idx=idx[0])
    with torch.no_grad():
        deltas, losses = eng.mesh.fed_map(
            eng._local_update, sx, sy, idx[0], replicated_args=(params0,),
            batched=False)
    b = tree_map(torch.add, params0, fed_mean(deltas, weights=counts))
    b_loss = fed_mean(losses, weights=counts).item()
    step = max((x - y).abs().max().item() for x, y in zip(
        tree_leaves(a[0]), tree_leaves(params0)))
    out["vmap_vs_loop_params"] = _max_diff(torch, a[0], b)
    # bf16 compute: the batched GEMMs sum in another order; 8 bf16 ulps
    # (2^-8) of the round's largest parameter step
    lim = 8 * 2.0**-8 * step
    print(f"gate vmap == loop (one round): params max_abs_err "
          f"{out['vmap_vs_loop_params']:.3e} tol {lim:.3e}; loss "
          f"{a[2].item():.6f} vs {b_loss:.6f}")
    gate(out["vmap_vs_loop_params"] <= lim, "vmap and loop rounds differ")
    gate(abs(a[2].item() - b_loss) <= 2.0**-8 * abs(b_loss),
          "vmap and loop round losses differ")

    # one station masked out == fed_mean over the others (sgd(1.0))
    drop = n_s // 2
    mask = torch.ones_like(counts)
    mask[drop] = 0
    masked = eng.round(params0, opt0, sx, sy, counts, mask=mask,
                       batch_idx=idx[0])
    with torch.no_grad():
        deltas, _ = eng.mesh.fed_map(eng._local_update, sx, sy, idx[0],
                                     replicated_args=(params0,), batched=True)
    keep = [s for s in range(n_s) if s != drop]
    mean = fed_mean(tree_map(lambda d: d[keep], deltas),
                    weights=counts[keep])
    expect = tree_map(torch.add, params0, mean)
    out["masked_vs_mean_of_others"] = _max_diff(torch, masked[0], expect)
    # f32 sums over 31 or 32 stations in another order: a few f32 ulps
    lim = 2.0**-20 * max(x.abs().max().item() for x in tree_leaves(expect))
    print(f"gate masked round == fed_mean of the other {n_s - 1}: params "
          f"max_abs_err {out['masked_vs_mean_of_others']:.3e} tol {lim:.3e}")
    gate(out["masked_vs_mean_of_others"] <= lim,
          "a masked round is not the mean over the other stations")

    # async_round == round(mask = accept * discount**staleness)
    spec = AsyncRoundSpec(quorum=n_s // 2, staleness_discount=0.5)
    g = torch.Generator().manual_seed(3)
    accept = (torch.rand(n_s, generator=g) < 0.6).float().to(counts.device)
    stale = torch.randint(0, 4, (n_s,), generator=g).float().to(counts.device)
    a = eng.async_round(params0, opt0, sx, sy, counts, None, accept, stale,
                        spec, batch_idx=idx[0])
    b = eng.round(params0, opt0, sx, sy, counts,
                  mask=accept * 0.5**stale, batch_idx=idx[0])
    out["async_vs_masked_round"] = _max_diff(torch, a[0], b[0])
    print(f"gate async_round == round(accept * 0.5**stale): params "
          f"max_abs_err {out['async_vs_masked_round']:.3e} (tolerance 0)")
    gate(out["async_vs_masked_round"] == 0 and bool(a[2] == b[2]),
          "async_round differs from the discounted-mask round")

    # learning_stats=True returns [k, S] stats from the fused run
    st = engine().run_rounds(params0, sx, sy, counts, None, k,
                             batch_idx=idx)[3]
    shapes = {n: tuple(v.shape) for n, v in st.items()}
    print(f"gate learning stats: {shapes}")
    gate(shapes.get("station_cos") == (k, n_s)
          and shapes.get("station_norm") == (k, n_s)
          and shapes.get("update_norm") == (k,)
          and all(bool(torch.isfinite(v).all()) for v in st.values()),
          "learning stats are not [k, S]")
    torch.cuda.synchronize()
    check(not failed, "fedavg gates failed: " + "; ".join(failed))
    return out


def phase_profile_fedavg(torch, state, label="fedavg"):
    """One traced fused FedAvg round (one replay of the captured graph):
    the device's busy share and device time by kernel group."""
    eng, params, opt, sx, sy, counts, gen = state
    eng.run_rounds(params, sx, sy, counts, gen, 1, opt_state=opt)
    wall_ms, rows = trace_device(torch, lambda: eng.run_rounds(
        params, sx, sy, counts, gen, 1, opt_state=opt))
    busy_ms = sum(r[0] for r in rows)

    def kind(name):
        low = name.lower()
        if any(w in low for w in ("sort", "radix", "onesweep")):
            return "sort (top-k)"
        if any(w in low for w in ("philox", "rand", "distribution")):
            return "RNG (draws)"
        if any(w in low for w in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                                  "implicit", "winograd", "fft")):
            return "cuDNN convolutions"
        if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass",
                                  "gemv", "dot_kernel")):
            return "GEMMs (dense layers)"
        if any(w in low for w in ("index", "gather", "scatter")):
            return "gather/scatter/index"
        if "memcpy" in low or "memset" in low:
            return "copies (rows in, losses out)"
        return "elementwise and reductions"

    groups: dict[str, float] = {}
    for ms, _, name in rows:
        groups[kind(name)] = groups.get(kind(name), 0.0) + ms
    share = busy_ms / wall_ms if wall_ms else 0.0
    print(f"profiled fused {label} round: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * share:.1f}%)")
    for name, ms in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"  {ms:9.3f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}%  {name}")
    for ms, n, key in rows[:15]:
        print(f"  {ms:9.3f} ms {n:6d}x {key[:90]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, busy_share=share,
                groups=groups,
                top=[dict(ms=m, count=n, name=k) for m, n, k in rows[:40]])


# ------------------------------------------------- phase 7: compression
# bench.py's compression leg (worker_compression): top-k 10% + int8 on the
# flagship config; it accepts at least 4x on-wire reduction and an accuracy
# gap of at most 0.08 (bench.py:197-198)
COMPRESSOR = dict(topk_ratio=0.1, int8=True)
MIN_REDUCTION = 4.0
MAX_ACCURACY_GAP = 0.08


def _fedavg_arm(torch, eng, params0, data, k, ex, ey):
    """A fresh k-round fused run from ``params0`` (warm-up, capture, k
    replays), then 3 chained timed runs of k rounds: figures of one arm."""
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    sx, sy, counts = data
    gen = torch.Generator(device=eng.device).manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, o, losses, _ = eng.run_rounds(params0, sx, sy, counts, gen, k)
    losses = losses.tolist()
    first_s = time.perf_counter() - t0
    check(eng.last_capture is not None, "run_rounds captured no CUDA graph")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"non-finite loss {losses}")
    acc = W.evaluate(p, ex, ey)
    state = [p, o]

    def fused_run():
        state[:] = eng.run_rounds(*state[:1], sx, sy, counts, gen, k,
                                  opt_state=state[1])[:2]

    ms, runs, _ = median_ms(torch, fused_run, FEDAVG["timed_runs"], warmup=0,
                            per=k)
    return dict(losses=losses, accuracy=acc, first_run_s=first_s,
                capture=dict(eng.last_capture), fused_ms_per_round=ms,
                fused_runs_ms=runs, rounds_per_s=1e3 / ms,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9), (p, o)


def phase_compression(fa, torch, dev, data):
    """Phase 7: the flagship config with and without compression from one
    init, the on-wire reduction, one compress_stacked call timed, and the
    error-feedback identities."""
    from vantage6_tpu_torch.fed.compression import CompressorSpec, \
        compress_stacked
    from vantage6_tpu_torch.utils.datasets import synthetic_image_classes
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    cfg = FEDAVG
    k, n_s = cfg["rounds"], cfg["stations"]
    spec = CompressorSpec(**COMPRESSOR)

    def engine(**kw):
        return W.make_engine(n_stations=n_s, device=dev,
                             local_steps=cfg["local_steps"],
                             batch_size=cfg["batch"], local_lr=cfg["lr"],
                             learning_stats=False, **kw)

    params0 = W.init_params(1, device=dev)
    ex, ey = synthetic_image_classes(FEDAVG_EVAL["n"], seed=FEDAVG_EVAL["seed"],
                                     noise=FEDAVG_EVAL["noise"])
    # this phase's counts start here
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    comp_eng = engine(compressor=spec)
    arms, states = {}, {}
    for name, eng in (("dense", engine()), ("compressed", comp_eng)):
        arms[name], states[name] = _fedavg_arm(torch, eng, params0, data, k,
                                               ex, ey)
        a = arms[name]
        print(f"compression arm {name}: fused {a['fused_ms_per_round']:.3f} "
              f"ms/round ({a['rounds_per_s']:.1f} rounds/s; runs "
              f"{a['fused_runs_ms']}), warm-up "
              f"{a['capture']['warmup_s']:.3f} s, capture "
              f"{a['capture']['capture_s']:.3f} s, first run "
              f"{a['first_run_s']:.3f} s, peak {a['peak_mem_gb']:.3f} GB, "
              f"losses {[round(x, 4) for x in a['losses']]}, accuracy "
              f"{a['accuracy']:.4f}")
    wire = comp_eng.compression_stats(params0)
    gap = abs(arms["dense"]["accuracy"] - arms["compressed"]["accuracy"])
    print(f"compression wire: {wire}; accuracy gap {gap:.4f} (at most "
          f"{MAX_ACCURACY_GAP})")

    # one compress_stacked call at the flagship's [S, N]
    n = wire["n_params"]
    g = torch.Generator(device=dev).manual_seed(4)
    flat = 1e-3 * torch.randn(n_s, n, generator=g, device=dev)
    ef = 1e-4 * torch.randn(n_s, n, generator=g, device=dev)
    stacked_ms = cuda_ms(lambda: compress_stacked(spec, flat, ef, g), 10)
    print(f"compress_stacked [{n_s}, {n}] topk 0.1 + int8: {stacked_ms:.4f} "
          f"ms per call (CUDA events, mean of 10)")
    del flat, ef

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gates = compression_gates(torch, engine, spec, params0,
                                  states["compressed"], data, k)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = dict(fa.flash_forward_cuda.variant_launches)
    check(sum(launches.values()) == 0,
          f"the compression runs launched a flash kernel: {launches}")
    check(wire["reduction"] >= MIN_REDUCTION,
          f"on-wire reduction {wire['reduction']} < {MIN_REDUCTION}")
    check(gap <= MAX_ACCURACY_GAP, f"accuracy gap {gap} > {MAX_ACCURACY_GAP}")
    check(arms["compressed"]["accuracy"] > FEDAVG_MIN_ACCURACY,
          f"compressed accuracy <= {FEDAVG_MIN_ACCURACY}")
    res = dict(config=dict(cfg, compressor=COMPRESSOR), arms=arms,
               wire=wire, accuracy_gap=gap,
               compress_stacked_ms=stacked_ms, compress_stacked_shape=[
                   n_s, n], gates=gates, launches=launches)
    p, o = states["compressed"]
    gen = torch.Generator(device=dev).manual_seed(6)
    return res, (comp_eng, p, o, *data, gen)


def compression_gates(torch, engine, spec, params0, state, data, k):
    """The error-feedback identities on the card; raises naming each that
    does not hold."""
    from vantage6_tpu_torch._tree import tree_leaves
    from vantage6_tpu_torch.fed.collectives import flatten_stacked
    from vantage6_tpu_torch.fed.compression import (
        CompressorSpec, compress_stacked, decompress_flat, draw_noise,
        noise_size)

    sx, sy, counts = data
    n_s = counts.shape[0]
    failed, out = [], {}

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a), tree_leaves(b), strict=True))

    eng = engine(compressor=spec)
    params, opt = state  # after the compressed arm's first 5 rounds
    g = torch.Generator(device=eng.device).manual_seed(5)
    idx = eng.draw_batch_indices(counts, g, 1)[0]
    n = opt["ef"].shape[1]
    u = draw_noise(g, (n_s, noise_size(spec, n)), eng.device)

    # one round: new_ef == acc - hat exactly, decompress(payload) == hat,
    # and the engine's round carries exactly that accumulator
    with torch.no_grad():
        deltas, _ = eng.mesh.fed_map(eng._local_update, sx, sy, idx,
                                     replicated_args=(params,), batched=True)
    flat = flatten_stacked(deltas)
    payload, hat, new_ef = compress_stacked(spec, flat, opt["ef"], None,
                                            noise=u)
    acc = flat + opt["ef"]
    out["ef_identity"] = torch.equal(new_ef, acc - hat)
    out["decompress_is_hat"] = torch.equal(
        decompress_flat(spec, payload, n), hat)
    _, o1, _, _ = eng.round(params, opt, sx, sy, counts, batch_idx=idx,
                            noise=u)
    out["round_ef_is_acc_minus_hat"] = torch.equal(o1["ef"], new_ef)
    out["survivors_per_station"] = int(payload["indices"].shape[1])
    print(f"gate new_ef == acc - hat (one round, [{n_s}, {n}]): "
          f"{out['ef_identity']}; decompress == hat: "
          f"{out['decompress_is_hat']}; the round's EF equal: "
          f"{out['round_ef_is_acc_minus_hat']}; survivors "
          f"{out['survivors_per_station']} of {n} (tolerance 0)")
    gate(out["ef_identity"], "new_ef != acc - hat")
    gate(out["decompress_is_hat"], "decompress_flat(payload) != hat")
    gate(out["round_ef_is_acc_minus_hat"], "the round's EF != acc - hat")

    # a masked station's EF row waits; the others move
    drop = n_s // 2
    mask = torch.ones_like(counts)
    mask[drop] = 0
    _, o2, _, _ = eng.round(params, opt, sx, sy, counts, mask=mask,
                            batch_idx=idx, noise=u)
    moved = [s for s in range(n_s)
             if not torch.equal(o2["ef"][s], opt["ef"][s])]
    out["masked_ef_unchanged"] = drop not in moved
    out["rows_moved"] = len(moved)
    print(f"gate masked station {drop}'s EF row unchanged: "
          f"{out['masked_ef_unchanged']}; rows moved {len(moved)} of {n_s}")
    gate(out["masked_ef_unchanged"] and len(moved) == n_s - 1,
         "a masked station's EF row moved")

    # k fused rounds == k eager rounds from generators of one seed (each
    # round draws its indices, then its noise)
    p_f, o_f, l_f, _ = eng.run_rounds(
        params0, sx, sy, counts,
        torch.Generator(device=eng.device).manual_seed(9), k)
    q, r, l_e = params0, eng.init(params0), []
    ge = torch.Generator(device=eng.device).manual_seed(9)
    for _ in range(k):
        q, r, loss, _ = eng.round(q, r, sx, sy, counts, key=ge)
        l_e.append(loss)
    out["fused_equals_eager"] = same((p_f, o_f), (q, r)) and torch.equal(
        l_f, torch.stack(l_e))
    print(f"gate fused == eager ({k} rounds, one generator seed): "
          f"{out['fused_equals_eager']} (tolerance 0)")
    gate(out["fused_equals_eager"], "compressed fused rounds differ from "
         "eager rounds")

    # an identity spec and lossless top-k give the dense params exactly
    idx_k = eng.draw_batch_indices(counts, g, k)
    dense = engine().run_rounds(params0, sx, sy, counts, None, k,
                                batch_idx=idx_k)
    for name, s in (("identity", CompressorSpec()),
                    ("topk_1.0", CompressorSpec(topk_ratio=1.0))):
        got = engine(compressor=s).run_rounds(params0, sx, sy, counts, None,
                                              k, batch_idx=idx_k)
        out[f"{name}_equals_dense"] = same(got[0], dense[0]) and \
            torch.equal(got[2], dense[2])
        print(f"gate {name} spec == dense ({k} rounds): "
              f"{out[f'{name}_equals_dense']} (tolerance 0)")
        gate(out[f"{name}_equals_dense"], f"the {name} spec differs from "
             "dense")
    torch.cuda.synchronize()
    check(not failed, "compression gates failed: " + "; ".join(failed))
    return out


# ---------------------------------------------- phase 8: analysis programs
# a hospital registry's size: 32 stations of up to 65,536 patients (ragged,
# padded); vertical LR over 4 stations of 262,144 shared patients
ANALYSIS = dict(stations=32, rows=65536, features=16, row_cats=12,
                col_cats=8, min_cell_count=5, quantiles=(0.5, 0.95),
                bisection_steps=64, glm_iter=25, vertical_stations=4,
                vertical_rows=262144, vertical_iter=100, vertical_lr=1.0,
                km_points=4096, seed=0)
# f32 correlation of 2M rows against np.corrcoef in float64: the moment
# sums carry ~1e-7 relative error each, and o/n - mean^2 cancels the
# means (0.5 against variances near 1)
CORR_ATOL = 1e-4
# float64 IRLS on the card against float64 IRLS in numpy, both converged;
# the 1e-8 jitter on X'WX (~1e6 here) moves beta by ~1e-14
GLM_RTOL, GLM_ATOL = 1e-7, 1e-9
# 100 f32 GD steps against float64 GD; each step's gradient is an f32
# sum over 262,144 rows
VERTICAL_ATOL = 2e-4


# Philox-4x32-10 of the zero counter under the zero key (Random123's
# known-answer vectors)
PHILOX_KAT = [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def _ragged(rng, cfg, torch, dev):
    """Per-station counts and the [S, n_max] row mask (f32, on the card)."""
    s, n = cfg["stations"], cfg["rows"]
    counts = rng.integers(n * 3 // 4, n + 1, size=s)
    counts[0] = n
    mask = (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)
    return counts, mask, torch.from_numpy(mask).to(dev)


def phase_analysis(fa, torch, dev, fedavg_state, profile=False):
    """Phase 8: every analysis program at a registry's size, each held to
    its numpy float64 oracle, with ms per call and peak memory; with
    ``profile``, one traced call of each (the device's busy share)."""
    from vantage6_tpu_torch._tree import tree_leaves
    from vantage6_tpu_torch.core.mesh import FederationMesh
    from vantage6_tpu_torch.fed import collectives as C
    from vantage6_tpu_torch.workloads import glm, quantiles, stats, vertical

    cfg = ANALYSIS
    rng = np.random.default_rng(cfg["seed"])
    n_s, n, p = cfg["stations"], cfg["rows"], cfg["features"]
    mesh = FederationMesh(n_s, device=dev)
    counts, mask_np, mask = _ragged(rng, cfg, torch, dev)
    keep = mask_np.astype(bool)
    res = {}
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)

    def timed(name, fn):
        torch.cuda.reset_peak_memory_stats()
        ms, runs, result = median_ms(torch, fn)
        res[name] = dict(ms=ms, runs_ms=runs,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        if profile:
            wall_ms, rows = trace_device(torch, fn)
            busy_ms = sum(r[0] for r in rows)
            # busy time over the untraced call: the profiler slows the host
            res[name]["profile"] = dict(
                traced_wall_ms=wall_ms, device_busy_ms=busy_ms,
                launches=sum(r[1] for r in rows),
                busy_share_untraced=busy_ms / ms)
        return result

    # correlation: correlated features with nonzero means
    mix = rng.normal(size=(p, p)) / np.sqrt(p) + np.eye(p)
    x = (rng.standard_normal((n_s, n, p)) @ mix + 0.5).astype(np.float32)
    x[~keep] = 0.0
    sx = torch.from_numpy(x).to(dev)
    corr = timed("correlation", lambda: stats.correlation_device(
        mesh, sx, mask)).cpu().numpy()
    ref = np.corrcoef(x[keep].astype(np.float64).T)
    err = float(np.abs(corr - ref).max())
    res["correlation"].update(max_abs_err=err, tol=CORR_ATOL,
                              shape=[n_s, n, p], rows=int(keep.sum()))
    check(err <= CORR_ATOL, f"correlation off np.corrcoef by {err}")

    # GLM in float64 on the card: intercept + p features
    design = np.concatenate([np.ones((n_s, n, 1)), x.astype(np.float64)],
                            axis=2)
    design[~keep] = 0.0
    sx64 = torch.from_numpy(design).to(dev)
    beta_true = rng.normal(size=p + 1) * 0.1
    eta = design @ beta_true
    labels = {
        "gaussian": eta + rng.normal(0, 0.5, eta.shape),
        "binomial": (rng.uniform(size=eta.shape)
                     < 1 / (1 + np.exp(-eta))).astype(np.float64),
        "poisson": rng.poisson(np.exp(eta)).astype(np.float64),
    }
    pooled_x = design[keep]
    for family, y in labels.items():
        y[~keep] = 0.0
        sy = torch.from_numpy(y).to(dev)
        m64 = mask.to(torch.float64)
        out = timed(f"glm_{family}", lambda: glm.fit_glm_device(
            mesh, sx64, sy, m64, family, n_iter=cfg["glm_iter"]))
        beta = out["beta"].cpu().numpy()
        ref = _numpy_irls(family, pooled_x, y[keep])
        err = float(np.abs(beta - ref).max())
        ok = np.allclose(beta, ref, rtol=GLM_RTOL, atol=GLM_ATOL)
        res[f"glm_{family}"].update(
            max_abs_err=err, rtol=GLM_RTOL, atol=GLM_ATOL,
            last_delta=float(out["deltas"][-1]), dtype="float64",
            shape=[n_s, n, p + 1])
        check(ok, f"glm {family} off numpy IRLS by {err}")
    del sx64, design

    # crosstab: skewed categories, so rare cells fall under the threshold
    r_p = rng.dirichlet(np.full(cfg["row_cats"], 0.5))
    c_p = rng.dirichlet(np.full(cfg["col_cats"], 0.5))
    rc = rng.choice(cfg["row_cats"], size=(n_s, n), p=r_p).astype(np.int32)
    cc = rng.choice(cfg["col_cats"], size=(n_s, n), p=c_p).astype(np.int32)
    rc[~keep] = 0
    cc[~keep] = 0
    rct, cct = torch.from_numpy(rc).to(dev), torch.from_numpy(cc).to(dev)
    table = timed("crosstab", lambda: stats.crosstab_device(
        mesh, rct, cct, mask, cfg["row_cats"], cfg["col_cats"],
        min_cell_count=cfg["min_cell_count"]))["table"]
    cells = cfg["row_cats"] * cfg["col_cats"]
    per = np.stack([np.bincount(rc[s][keep[s]] * cfg["col_cats"]
                                + cc[s][keep[s]], minlength=cells)
                    for s in range(n_s)]).reshape(n_s, cfg["row_cats"],
                                                  cfg["col_cats"])
    poisoned = ((per > 0) & (per < cfg["min_cell_count"])).any(0)
    expect = [[None if poisoned[r, c] else int(per[:, r, c].sum())
               for c in range(cfg["col_cats"])]
              for r in range(cfg["row_cats"])]
    res["crosstab"].update(exact=table == expect,
                           poisoned_cells=int(poisoned.sum()),
                           shape=[n_s, n], cats=[cfg["row_cats"],
                                                 cfg["col_cats"]])
    check(table == expect, "crosstab differs from the pooled counts")

    # quantiles of a lab value (log-normal, f32)
    v = np.exp(rng.normal(4.0, 0.5, size=(n_s, n))).astype(np.float32)
    v[~keep] = 0.0
    vt = torch.from_numpy(v).to(dev)
    pooled_v = np.sort(v[keep])
    for q in cfg["quantiles"]:
        got = timed(f"quantile_{q}", lambda: quantiles.quantile_device(
            mesh, vt, mask, q=q, n_iter=cfg["bisection_steps"]))
        rank = float(pooled_v[int(np.ceil(q * len(pooled_v))) - 1])
        res[f"quantile_{q}"].update(value=got["value"], rank_value=rank,
                                    n=got["n"], shape=[n_s, n])
        check(got["value"] == rank and got["n"] == len(pooled_v),
              f"quantile {q}: {got['value']} != rank value {rank}")

    # vertical LR: 4 stations of p features each over the same patients
    vs, vn = cfg["vertical_stations"], cfg["vertical_rows"]
    xv = rng.standard_normal((vs, vn, p)).astype(np.float32)
    w_true = rng.normal(size=(vs, p)) * 0.3
    logit = np.einsum("snp,sp->n", xv.astype(np.float64), w_true) - 0.2
    yv = (rng.uniform(size=vn) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    vmesh = FederationMesh(vs, device=dev)
    xvt, yvt = torch.from_numpy(xv).to(dev), torch.from_numpy(yv).to(dev)
    out = timed("vertical", lambda: vertical.fit_vertical_logistic_device(
        vmesh, xvt, yvt, n_iter=cfg["vertical_iter"],
        lr=cfg["vertical_lr"]))
    xcat = np.concatenate(list(xv), axis=1).astype(np.float64)
    w, b = np.zeros(vs * p), 0.0
    for _ in range(cfg["vertical_iter"]):
        mu = 1 / (1 + np.exp(-(xcat @ w + b)))
        w = w - cfg["vertical_lr"] * (xcat.T @ (mu - yv) / vn)
        b = b - cfg["vertical_lr"] * np.sum(mu - yv) / vn
    got = out["weights"].cpu().numpy().reshape(-1)
    err = max(float(np.abs(got - w).max()),
              abs(float(out["bias"]) - b))
    res["vertical"].update(max_abs_err=err, tol=VERTICAL_ATOL,
                           shape=[vs, vn, p], iterations=cfg["vertical_iter"],
                           final_loss=float(out["losses"][-1]))
    check(err <= VERTICAL_ATOL, f"vertical LR off pooled GD by {err}")
    del xvt, sx

    # secure sums: one round's flagship CNN deltas, count-weighted
    eng, params, _, fx, fy, fcounts, gen = fedavg_state
    idx = eng.draw_batch_indices(fcounts, gen, 1)[0]
    with torch.no_grad():
        deltas, _ = eng.mesh.fed_map(eng._local_update, fx, fy, idx,
                                     replicated_args=(params,), batched=True)
    scale = 2.0**16
    wsum = max(float((d.abs().flatten(1).max(1).values * fcounts).sum())
               for d in tree_leaves(deltas))
    check(wsum < 2.0**31 / scale, f"deltas out of secure_sum's range {wsum}")
    sec = timed("secure_fed_mean_cnn", lambda: C.secure_fed_mean(
        deltas, fcounts, 17, scale))
    plain = C.fed_mean(deltas, weights=fcounts)
    total = float(fcounts.sum())
    tol = fcounts.shape[0] * 0.5 / scale / total
    err = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(sec), tree_leaves(plain)))
    # the masks cancel exactly: the secure sum of the flat weighted deltas
    # is the plain int32 sum of their quantized values
    flat = C.flatten_stacked(deltas) * fcounts.reshape(-1, 1)
    exact = torch.equal(
        C.secure_sum(flat, 17, scale),
        C.dequantize(C._wrap32(torch.sum(C.quantize(flat, scale), dim=0,
                                         dtype=torch.int64)), scale))
    res["secure_fed_mean_cnn"].update(
        max_abs_err=err, tol=tol + 1e-7, masks_cancel_exactly=exact,
        shape=[fcounts.shape[0], int(flat.shape[1])])
    check(exact, "secure_sum's masks did not cancel")
    check(err <= tol + 1e-7, f"secure_fed_mean off fed_mean by {err}")
    # the pair masks' Philox-4x32-10 gives the published known answer on
    # the card (Random123's zero counter and key)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    kat = [int(w) for w in C._philox([zero] * 4, 0, 0)]
    res["secure_fed_mean_cnn"]["philox_known_answer"] = kat == PHILOX_KAT
    check(kat == PHILOX_KAT, f"Philox on the card gave {kat}")
    del deltas, flat, sec, plain

    # KM-sized counts: at-risk numbers over 4096 event times, exact in
    # 2^-9 steps
    t = cfg["km_points"]
    at_risk = np.stack([np.sort(rng.integers(0, c + 1, size=t))[::-1]
                        for c in counts]).astype(np.float32)
    km = {"at_risk": torch.from_numpy(at_risk).to(dev)}
    ones = torch.ones(n_s, device=dev)
    sec = timed("secure_fed_mean_km", lambda: C.secure_fed_mean(
        km, ones, 23, 2.0**9))
    exact = torch.equal(sec["at_risk"], C.fed_mean(km, weights=ones)[
        "at_risk"])
    res["secure_fed_mean_km"].update(exact=exact, shape=[n_s, t])
    check(exact, "secure_fed_mean of counts is not the exact mean")

    launches = dict(fa.flash_forward_cuda.variant_launches)
    check(sum(launches.values()) == 0,
          f"the analysis programs launched a flash kernel: {launches}")
    for name, r in res.items():
        extra = {k: v for k, v in r.items()
                 if k not in ("ms", "runs_ms", "peak_mem_gb")}
        print(f"analysis {name}: {r['ms']:.3f} ms per call (median of 3; "
              f"runs {[round(x, 3) for x in r['runs_ms']]}), peak "
              f"{r['peak_mem_gb']:.3f} GB, {extra}")
    return dict(config=cfg, programs=res, launches=launches)


def _numpy_irls(family, x, y, n_iter=50):
    """Pooled float64 IRLS in numpy, to convergence (the oracle)."""
    beta = np.zeros(x.shape[1])
    for _ in range(n_iter):
        eta = x @ beta
        if family == "gaussian":
            mu, w = eta, np.ones_like(eta)
        elif family == "binomial":
            mu = 1 / (1 + np.exp(-eta))
            w = mu * (1 - mu)
        else:
            mu = np.exp(eta)
            w = mu
        step = np.linalg.solve(x.T @ (x * w[:, None]), x.T @ (y - mu))
        beta = beta + step
        if np.abs(step).max() < 1e-13:
            break
    return beta


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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
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
    fedavg, fedavg_state = phase_fedavg(fa, torch, dev)
    if "--profile" in argv:
        prof["fedavg"] = phase_profile_fedavg(torch, fedavg_state)
    compression, comp_state = phase_compression(fa, torch, dev,
                                                fedavg_state[3:6])
    if "--profile" in argv:
        prof["compression"] = phase_profile_fedavg(torch, comp_state,
                                                   "compressed fedavg")
    del comp_state
    analysis = phase_analysis(fa, torch, dev, fedavg_state,
                              profile="--profile" in argv)
    del fedavg_state
    print(f"fedavg-cnn: {fedavg['fused_ms_per_round']:.3f} ms/round fused "
          f"({fedavg['rounds_per_s']:.1f} rounds/s), "
          f"{fedavg['eager_ms_per_round']:.3f} ms/round eager, "
          f"warm-up {fedavg['capture']['warmup_s']:.3f} s, capture "
          f"{fedavg['capture']['capture_s']:.3f} s, peak "
          f"{fedavg['peak_mem_gb']:.3f} GB, final loss "
          f"{fedavg['final_loss']:.4f}, accuracy {fedavg['accuracy']:.4f} "
          f"on {card}")
    for name, a in compression["arms"].items():
        print(f"compression {name}: {a['fused_ms_per_round']:.3f} ms/round "
              f"fused ({a['rounds_per_s']:.1f} rounds/s), peak "
              f"{a['peak_mem_gb']:.3f} GB, accuracy {a['accuracy']:.4f} on "
              f"{card}")
    print(f"compression: reduction {compression['wire']['reduction']}x, "
          f"accuracy gap {compression['accuracy_gap']:.4f}, compress_stacked "
          f"{compression['compress_stacked_ms']:.4f} ms on {card}")
    for name, r in analysis["programs"].items():
        print(f"analysis {name}: {r['ms']:.3f} ms per call, peak "
              f"{r['peak_mem_gb']:.3f} GB on {card}")

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
        launches=sum(r["launches"][variant] for r in slice_res.values())
        + fedavg["launches"][variant],
        launches_fedavg=fedavg["launches"][variant],
        launches_compression=compression["launches"][variant],
        launches_analysis=analysis["launches"][variant],
        **{key: times[dtype][variant][key] for key in (
            "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    ) for variant, (name, dtype) in names.items()]
    result = dict(card=card, kind=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  max_abs_err_cases=max_err_cases, slice=slice_res,
                  fedavg=fedavg, compression=compression, analysis=analysis,
                  kernels=kernels, times=times, profile=prof,
                  seconds=time.perf_counter() - t_start)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"slice": slice_res, "fedavg": fedavg,
                      "compression": compression, "analysis": analysis}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
