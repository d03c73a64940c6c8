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
   port never calls it); then the CUDA-core kernel at the shape it
   serves, [16, 8, 1024, 8] bf16 causal, the same figures;
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

9. the ring path, ``TransformerConfig``'s default attention, at phase 4's
   width through ``make_engine``/``init``/``shard_tokens``/``round`` for
   8 rounds, station 3 masked in round 2: one sequence shard in bf16 and
   in f32 compute, four shards in bf16; ms/round, tokens/s and peak
   memory of each run. In each the loss must be finite and fall and no
   flash kernel may launch; at one shard round 0's loss must equal a
   flash round's from the same state within phase 4's loss tolerance.
   Then ``ring_attention_sharded`` at ``[16, 1024, 8, 128]`` causal over
   4 shards against ``reference_attention`` (f32 within 2e-5; bf16
   against the f32 oracle within 2 bf16 ulps), ``tp_mlp`` at d_model
   1024, hidden 4096, on 2 and 4 shards against the dense MLP (1e-5), and
   the trained full-width params (105M f32, on the card) through the v2
   wire format and back bit for bit, encode and decode timed.

10. the task plane at full width, the way a vantage6 user drives it: a
   ``Federation`` built from ``FederationConfig.from_dict`` (no YAML), one
   station per flagship shard of phase 6; ``central_fedavg`` for 5 rounds
   through ``create_task`` (the central function in host mode, each
   round's partials one device-mode subtask), its params equal to 5 eager
   ``FedAvg.round`` calls under sgd(1.0) from the same init and draws,
   its loss falling and its accuracy above 0.2, ms per round beside the
   engine's eager round and peak memory; ``run_fused_rounds`` (K = 5)
   with one station masked equal to ``engine.run_rounds`` with that mask,
   rounds/s; ``central_average_device`` over phase 8's registry size
   against a float64 numpy oracle, ms per call; ``aggregate_stacked``'s
   three modes on one round's CNN deltas with one station offline (it is
   excluded); a host-mode task over dicts of arrays at 0 and 8 executor
   workers (equal results, ``task_timing``'s sum, max and straggler); a
   checkpoint round trip of params, Adam state and generator state (bit
   for bit, and 2 rounds after the restore equal to 2 uninterrupted); no
   flash kernel may launch.

11. the observed, compressed planes on phase 6's flagship: a
   ``Federation`` from ``FederationConfig.from_dict`` with the reference's
   ``compression: {topk_ratio: 0.1, int8: true}``. (a) Two host-mode
   tasks whose partial trains its station's CNN delta on the card and
   returns ``client.compress_update(delta)``; the central carries each
   payload over the v2 wire and ``decompress_update``s it: each decoded
   delta equals the ``hat`` that ``compress_delta`` gives when the
   exchange is replayed from its generator, bit for bit, ``new_ef == acc
   - hat`` and the EF store holds it, exactly; the store advanced between
   the tasks; the mean within 1e-6 of ``fed_mean`` over the hats; the
   wire reduction at least 4x; ms per compress and decompress, encode
   and decode ms. (b) ``central_fedavg``'s 5 rounds, each aggregated
   through ``client.aggregate_stacked``, through ``create_task`` record
   5 rounds in ``learning_history``,
   each station's norm and cosine within 1e-5 of a float64 numpy
   recompute from the pulled stacked results; the runtime round with
   ``learning_stats`` on and off, in turns; ``FedAvg.attach_history``
   over ``run_rounds`` (K = 5) records the returned stats exactly; the
   fused round with and without a history, in turns. (c) The device
   observatory on a fresh engine: the first ``run_rounds`` of a
   signature is one ``device.compile`` span with warm-up and capture
   ms and the memory the capture took, the same signature again none
   and one counted dispatch, half the rows per station one retrace
   naming ``[0][1]`` before -> after; ``profile_window`` around one
   fused round writes a trace holding CUDA kernel events, noted in the
   flight recorder. (d) ``FLIGHT.dump`` holds the task's ``learning``
   record and the ``retrace`` note. No flash kernel may launch.

12. the parity ladder's tasks through ``Federation.create_task`` at a
   registry's size: 32 stations of up to 65,536 patients (ragged, as
   phase 8's) with 16 N(0, 1) covariates, event times in integer weeks
   over 10 years (T ~ Exponential(exp(x.beta*)/200), censoring
   Uniform(0, 520)), logistic labels; each station's device data a dict
   of padded tensors and ``count``, its host data a dict of columns.
   ``fit_device`` (100 iterations) against float64 numpy GD and
   ``central_logistic`` (host, 10) against ``fit_device`` at 10;
   ``kaplan_meier_device`` plain and ``secure=True`` (counts equal to
   numpy's exactly, survival within 3 x K x 2^-24 of a float64
   ``cumprod``) and ``central_kaplan_meier`` (exact); ``fit_cox_device``
   (10 Newton steps) against a float64 pooled Breslow Newton, its peak
   memory under 40 GB, and ``central_cox`` (host, 3) against
   ``fit_cox_device`` at 3; ``summary_device`` and ``central_summary``
   against numpy float64; the host centrals of phase 8's programs at its
   sizes (``central_glm`` for each family against numpy IRLS,
   ``central_quantile`` 0.5 and 0.95 equal to the rank value,
   ``central_crosstab`` exact, ``central_correlation``, and
   ``central_vertical_logistic`` over 4 x 262,144 for 3 iterations, its
   per-sample lists sized for the wire at every exchange); ms per call
   (median of 3, synchronised) and peak memory of each. No flash kernel
   may launch.

13. multi-process federation on an NCCL group of one rank (the card's
   only rank: NCCL cannot put two ranks on one card), joined the way a
   deployment joins, through ``core.distributed.initialize`` from
   ``V6T_COORDINATOR``/``V6T_NUM_PROCESSES``/``V6T_PROCESS_ID``; the
   backend and NCCL version printed. ``global_mesh``, ``local_stations``
   and ``stack_local_shards`` at 32 stations; ``fed_mean_scattered_tree``
   over one flagship round's CNN deltas ``[32, 421642]`` through NCCL's
   reduce-scatter and all-gather, bit-identical to the one-card form in
   f32 and in bf16 comm, each timed (CUDA events, in turns); one eager
   FedAvg round of phase 6's flagship on the group mesh, bit-identical to
   the round on the plain mesh from the same state and indices (cuDNN
   deterministic), ms per round of each, in turns; ``device_column_stats``
   over one station of 65,536 rows against float64 numpy, and
   ``device_logistic_fit`` over 65,536 rows x 16 features (5 rounds of 4
   local steps, lr 0.5) in its three ``agg_mode``s against a float64 numpy
   replay of the same rounds, ms per call (median of 3, synchronised) and
   peak memory; the per-rank ``ring_attention`` (one rank) against
   ``ring_attention_sharded`` at one shard and ``tp_mlp`` over the group
   against the dense MLP at phase 9's shapes, errors and ms. The group is
   destroyed at the end; no flash kernel may launch.

14. the ops plane around FedAvg, after a line saying whether ``requests``
   and ``cryptography`` import here. (a) The reference benchmark's
   straggler arm (``bench.py:2692-2770``): 8 host stations of 128 rows at
   8 executor workers, clean sync rounds, sync rounds with a ``FAULTS``
   delay on station 0 of ``min(1, max(0.2, 9 x the clean round))`` s, and
   ``run_buffered`` (quorum 7, over-select 1); rounds/s the median of 3
   timed runs of 6 rounds, each arm after one untimed round, with the
   collector off; its gates: async at least 80% of clean, sync with the
   straggler at most half, the aggregate within 2%. Then a Federation
   with ``autopilot: {enabled: true}``: ``straggler_station`` names
   station 0, whose selection weight drops to 0.25 and returns to 1.0
   after clean rounds clear the alert. (b) The reference's closed loop
   (``bench.py:2771-2850``) on the card: 8 stations x 32 rows x 16
   features of linear least squares, station 5 label-flipped by
   ``FAULTS.poison_labels`` on the card, 6 fused rounds poisoned and
   clean, the history recorded while ``WATCHDOG`` runs at 0.4 s with an
   ``Autopilot(ArrayActuator(8))``: station 5 masked within 1.3 s, the
   masked run recovers (its final loss under the poisoned one and at most
   max(1.5 x clean, clean + 0.05)), the mask reverts after
   ``LEARNING.clear()``; a flight dump taken while masked holds the
   ``alert`` record, one taken after holds the ``autopilot_action`` and
   ``autopilot_revert`` notes. (c) The same loop on phase 6's flagship
   (cuDNN deterministic, learning stats on): the station with the most
   rows has its labels permuted (``CONTRARIAN_PERM``); the alert names it
   alone, ``ArrayActuator(32)`` masks it, a fused run under the
   actuator's numpy mask is more accurate on phase 6's eval set than the
   poisoned run and equal bit for bit to a run with the same mask by
   hand, no new graph is captured, and the mask reverts; detection
   latency, fused ms/round poisoned and masked, peak memory. (e) A
   phase-10-shaped Federation pushing over HTTP to a port ``ServerApp``'s
   ``/api/telemetry`` (``attach_fleet_push``, interval 0) through
   ``central_fedavg`` for 3 rounds: one push per round boundary, each
   decoding to its ``build_snapshot``, each carrying ``v6t_device_*``, and
   each read back from ``/api/fleet`` (the source's seq and series count);
   ms per push. (d)
   With that Federation open, one ``WATCHDOG.evaluate()`` over the
   learning, device-plane and Federation feeds: no feed error; its ms and
   the health verdict. (f) Where ``cryptography`` imports: a run's
   ``identity()`` signs an advert its ``org_identities()`` verify (and
   another station's key refuses), a 1 MB payload round-trips as an
   RSA-sealed v2 frame; keygen, encrypt and decrypt ms. No flash kernel
   may launch.

15. the host crypto and secure aggregation (``cryptography`` required).
   (a) The native library built by g++ from
   ``vantage6_tpu_torch/native/secureagg.cpp`` into ``build/native``
   (no numpy fallback allowed); one flagship FedAvg-CNN round's station
   deltas ``[32, 421642]`` (phase 13's round) pulled to the host, each
   station's masked by ``native.mask_update`` under one fresh tag and
   summed by ``native.unmask_sum``: within 32 x 0.5/scale of the card's
   ``fed_sum``, the last station's upload equal bit for bit to the numpy
   fallback's; ms per station (native and numpy) and the unmask ms. (b)
   Phase 12's registry (32 stations of up to 65,536 patients, covariate
   f0, host dicts of columns) in one ``Federation`` on the card: the
   seeded, DH (adverts signed by the stations' RSA identities, whose 32
   keygens are timed apart) and Bonawitz averages, and Bonawitz again
   with station 7's upload swallowed by the ``drop`` fault; counts exact,
   averages within 1e-3 of the float64 pooled mean, the dropout run
   naming station 7 and averaging the survivors; wall ms of each. (c)
   Rung 5: ``central_kaplan_meier_paillier`` under a 2048-bit key on a
   yearly grid of 10 points (weeks 52-520; the full 519-week grid would
   take ~33,000 encryptions): every aggregate ciphertext, the decrypted
   counts equal to the plain partials' and numpy's, survival within
   1e-12 of the float64 KM; encryptions/s and the task's wall ms. (d)
   ``preprocess`` where pandas imports, else one line saying it was not
   run. No flash kernel may launch.

16. the REST stack on the card: a port ``ServerApp`` on a real socket, a
   port ``UserClient`` and port ``NodeDaemon``s as threads of this
   process. (a) The reference's control-plane leg as it stands
   (``bench.py:114-116, 1127-1288``): 8 inline daemons, each on a CSV of
   32 ages, 40 ``partial_average`` tasks of width 2 submitted back to back,
   once per-run + polled and once batched + pushed, each arm on a fresh
   server; every task completed with exactly one run per targeted
   organization, the arms' results identical and each task's mean equal
   to numpy's (1e-12); task and dispatch p50/p95, tasks/s, REST calls per
   task. (b) Phase 13's station (65,536 patients x 16 covariates) as a CSV
   behind a daemon with ``device_engine={}`` (the card): ``engine="device"``
   tasks of ``device_column_stats`` and ``device_logistic_fit`` in its three
   ``agg_mode``s with phase 13's parameters, each result equal bit for bit
   to the same call made directly on the card, submit->result ms beside
   the direct call's (medians of 3, in turns), and a ``POST
   /api/debug/profile`` window around one task holding CUDA kernel events.
   (c) Phase 12's registry (covariate f0, 1,817,882 patients at seed 12)
   behind 32 inline daemons: ``central_average`` researcher -> node A ->
   proxy -> 32 runs -> aggregate, its count exact and its average within
   1e-14 of the in-process ``Federation``'s and 1e-12 of numpy's; wall ms
   of both. (d) One ``partial_average`` through a sandbox-mode daemon: a
   child process with the card hidden and ``jax`` shadowed by a package
   that records any import; the child's wall ms. (e) ``/api/health`` ok,
   ``/api/metrics`` with the server's series and ``v6t_device_*``, and
   each daemon of (b)-(d) read back from ``/api/fleet`` (each pushes every
   0.5 s). No flash kernel may launch.

``--profile`` traces one more round of each run of phases 4 and 9
(torch.profiler) and reports device time by kernel group and under the
``attention_fwd``/``attention_bwd`` profiler ranges, one fused round of
phases 6 and 7 (dense and compressed) with the device's busy share, and
one call of each analysis program of phase 8 (kernel time, launches),
one runtime round and one eager round of phase 10 (device busy share,
launches, the host's costliest functions), and one call of
``fit_cox_device`` and ``fit_device`` of phase 12 (busy share, launches,
the costliest kernels).

Prints the card's name and power limit first and again before a
``{"kernels": [...]}`` line, which comes before the last, and
``{"ok": true, "device": {...}}`` as the last line. Without a CUDA device it exits 1 and prints no result. A copy of the
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

# the ring path's runs: (compute dtype, seq_devices)
RING_RUNS = (("bfloat16", 1), ("float32", 1), ("bfloat16", 4))
RING_CHECK_SHARDS = 4  # ring_attention_sharded's check at the main shape
TP_SHARDS = (2, 4)
TP_TOL = 1e-5  # the CPU parity tests' tp_mlp tolerance

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


def slice_engine(ft, torch, dtype=None, seq_devices=1, **cfg_kw):
    """The slice's engine at full width on the card, its tokens and its
    initial state. ``dtype`` is the compute dtype, None for
    ``TransformerConfig``'s default (f32); ``cfg_kw`` overrides other
    config fields (``attention``)."""
    cfg = ft.TransformerConfig(
        vocab=FULL["vocab"], d_model=FULL["d_model"],
        n_heads=FULL["n_heads"], n_layers=FULL["n_layers"],
        max_len=FULL["seq"], **cfg_kw,
        **({} if dtype is None else {"dtype": dtype}),
    )
    n_s = FULL["stations"]
    eng = ft.make_engine(n_stations=n_s, seq_devices=seq_devices, cfg=cfg,
                         lr=1e-3)
    check(eng.device.type == "cuda", "engine is not on the card")
    tokens = eng.shard_tokens(ft.make_federated_tokens(
        n_s, batch=FULL["batch"], seq_len=FULL["seq"], vocab=FULL["vocab"],
    ))
    params, opt = eng.init(torch.Generator().manual_seed(0))
    return cfg, eng, tokens, params, opt


def train_rounds(torch, eng, params, opt, tokens, label):
    """ROUNDS rounds from (params, opt), station 3 masked out in
    DROP_ROUND; checks that the losses are finite and fall and the params
    finite. Returns (params, opt, losses, seconds a round, the state the
    last round started from)."""
    n_s = FULL["stations"]
    full = torch.ones(n_s)
    drop = torch.tensor([1.0] * (n_s - 1) + [0.0])
    losses, secs = [], []
    for r in range(ROUNDS):
        state = (params, opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = eng.round(params, opt, tokens,
                                      drop if r == DROP_ROUND else full)
        loss = loss.item()  # waits for the round
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"{label} round {r} "
              f"mask={'drop3' if r == DROP_ROUND else 'all'} "
              f"loss {loss:.6f} {1e3 * secs[-1]:.1f} ms")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"{label}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in
              [params["embed"], params["pos"]]
              + [w for layer in params["layers"] for w in layer.values()]),
          f"{label}: non-finite parameters")
    return params, opt, losses, secs, state


def round_figures(torch, secs):
    """ms/round over the steady rounds (round 0 carries one-time set-up:
    cuBLAS, the kernels' first launch), tokens/s and the peak memory."""
    steady = secs[1:]
    ms = 1e3 * sum(steady) / len(steady)
    tokens_per_round = FULL["stations"] * FULL["batch"] * FULL["seq"]
    return dict(ms_per_round=ms, first_round_ms=1e3 * secs[0],
                round_ms=[1e3 * s for s in secs],
                tokens_per_s=tokens_per_round / (ms / 1e3),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def phase_slice(fa, ft, torch, dev, dtype=None):
    """The slice at full width for ROUNDS rounds, flash attention;
    ``dtype`` is the compute dtype, None for ``TransformerConfig``'s
    default (f32)."""
    cfg, eng, tokens, params, opt = slice_engine(ft, torch, dtype,
                                                 attention="flash")
    dtype_name = str(cfg.dtype).removeprefix("torch.")
    variant = MAIN_VARIANT[dtype_name]
    check(fa.kernel_variant(cfg.dtype, cfg.head_dim) == variant,
          f"{dtype_name} attention is not served by the {variant} kernel")
    loss_rtol = LOSS_RTOL_F32 if cfg.dtype == torch.float32 else LOSS_RTOL
    n_s = FULL["stations"]
    full = torch.ones(n_s)

    # the main path's counts start here
    torch.cuda.reset_peak_memory_stats()
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    params, opt, losses, secs, state = train_rounds(
        torch, eng, params, opt, tokens, dtype_name)
    launches = dict(fa.flash_forward_cuda.variant_launches)
    figures = round_figures(torch, secs)
    expect = ROUNDS * n_s * cfg.n_layers
    print(f"flash kernel launches in the {dtype_name} run: {launches} "
          f"(rounds x stations x layers = {expect})")
    check(launches[variant] == expect,
          f"the {dtype_name} run did not run the {variant} kernel")
    check(sum(launches.values()) == expect,
          f"the {dtype_name} run ran another kernel than {variant}")

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

    res = dict(
        config=dict(FULL, dtype=dtype_name, attention="flash", lr=1e-3),
        rounds=ROUNDS, losses=losses, **figures,
        launches=launches, launches_per_round=n_s * cfg.n_layers,
        recompute_loss=rc_loss, loss_rel_diff=rel, loss_rtol=loss_rtol,
    )
    print(f"{dtype_name} slice: {res['ms_per_round']:.1f} ms/round, "
          f"{res['tokens_per_s']:.0f} tokens/s, peak "
          f"{res['peak_mem_gb']:.2f} GB")
    return res, (eng, params, opt, tokens, full)


def phase_ring(fa, ft, torch, dtype_name, seq_devices):
    """The slice at full width through ``TransformerConfig``'s default
    attention, the ring, over ``seq_devices`` sequence shards, in
    ``dtype_name`` compute, for ROUNDS rounds. No flash kernel may launch.
    At one shard, round 0's loss must equal a flash round's from the same
    state. Returns (figures, (engine, final params, optimizer state,
    tokens, a full mask))."""
    dtype = None if dtype_name == "float32" else getattr(torch, dtype_name)
    cfg, eng, tokens, params0, opt0 = slice_engine(
        ft, torch, dtype, seq_devices=seq_devices)
    check(cfg.attention == "ring", "the default attention is not the ring")
    check(str(cfg.dtype) == f"torch.{dtype_name}", "compute dtype")
    label = f"ring P={seq_devices} {dtype_name}"

    # the main path's counts start here
    torch.cuda.reset_peak_memory_stats()
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    params, opt, losses, secs, _ = train_rounds(torch, eng, params0, opt0,
                                                tokens, label)
    launches = dict(fa.flash_forward_cuda.variant_launches)
    figures = round_figures(torch, secs)
    print(f"flash kernel launches in the {label} run: {launches}")
    check(sum(launches.values()) == 0,
          f"the {label} run launched a flash kernel")
    res = dict(config=dict(FULL, dtype=dtype_name, attention="ring",
                           seq_devices=seq_devices, lr=1e-3),
               rounds=ROUNDS, losses=losses, launches=launches, **figures)
    if seq_devices == 1:
        loss_rtol = LOSS_RTOL_F32 if dtype is None else LOSS_RTOL
        fl_eng = ft.make_engine(
            n_stations=FULL["stations"], seq_devices=1,
            cfg=dataclasses.replace(cfg, attention="flash"), lr=1e-3)
        fl_loss = fl_eng.round(params0, opt0, tokens,
                               torch.ones(FULL["stations"]))[2].item()
        rel = abs(losses[0] - fl_loss) / abs(fl_loss)
        print(f"{label} round 0 loss {losses[0]:.6f}, flash round from the "
              f"same state {fl_loss:.6f}: rel diff {rel:.3e} tol "
              f"{loss_rtol:.3e}")
        check(rel <= loss_rtol, f"{label}: ring and flash losses disagree")
        res.update(flash_loss=fl_loss, loss_rel_diff=rel,
                   loss_rtol=loss_rtol)
    print(f"{label}: {res['ms_per_round']:.1f} ms/round, "
          f"{res['tokens_per_s']:.0f} tokens/s, peak "
          f"{res['peak_mem_gb']:.2f} GB")
    return res, (eng, params, opt, tokens, torch.ones(FULL["stations"]))


def phase_parallel_ops(torch, dev):
    """``ring_attention_sharded`` against ``reference_attention`` and
    ``tp_mlp`` against the dense MLP at the main path's shapes, each
    timed (CUDA events) beside its plain counterpart."""
    from vantage6_tpu_torch.parallel import (reference_attention,
                                             ring_attention_sharded,
                                             shard_params_for_tp, tp_mlp)

    b, t, h = FULL["batch"], FULL["seq"], FULL["n_heads"]
    d = FULL["d_model"] // h
    g = torch.Generator(device=dev).manual_seed(4)
    res = {}
    q, k, v = (torch.randn(b, t, h, d, generator=g, device=dev)
               for _ in range(3))
    oracle = reference_attention(q, k, v, causal=True)
    for name, dtype, tol in (("float32", torch.float32, F32_TOL),
                             ("bfloat16", torch.bfloat16, BF16_TOL)):
        # bf16: held to the f32 oracle on the same (bf16-exact) inputs
        qc, kc, vc = (x.to(dtype) for x in (q, k, v))
        ref = oracle if dtype == torch.float32 else reference_attention(
            qc.float(), kc.float(), vc.float(), causal=True)
        out = ring_attention_sharded(qc, kc, vc, RING_CHECK_SHARDS,
                                     causal=True)
        check(out.dtype == dtype and out.shape == q.shape, "ring output")
        err = (out.float() - ref).abs().max().item()
        lim = tol + tol * ref.abs().max().item()
        ms = cuda_ms(lambda: ring_attention_sharded(
            qc, kc, vc, RING_CHECK_SHARDS, causal=True), 3, warmup=1)
        ref_ms = cuda_ms(lambda: reference_attention(
            qc, kc, vc, causal=True), 3, warmup=1)
        print(f"ring_attention_sharded [{b},{t},{h},{d}] {name} causal, "
              f"{RING_CHECK_SHARDS} shards, vs f32 reference_attention: "
              f"max_abs_err {err:.3e} tol {lim:.3e}; {ms:.3f} ms, "
              f"reference_attention in {name} {ref_ms:.3f} ms")
        check(err <= lim, f"ring attention off the reference in {name}")
        res[f"ring_{name}"] = dict(max_abs_err=err, tol=lim, ms=ms,
                                   reference_ms=ref_ms,
                                   shards=RING_CHECK_SHARDS)
    del q, k, v, oracle, out, ref

    dm = FULL["d_model"]
    x = torch.randn(b, t, dm, generator=g, device=dev)
    w_up = 0.02 * torch.randn(dm, 4 * dm, generator=g, device=dev)
    w_down = 0.02 * torch.randn(4 * dm, dm, generator=g, device=dev)

    def dense():
        return torch.nn.functional.gelu(x @ w_up, approximate="tanh") @ w_down

    want = dense()
    dense_ms = cuda_ms(dense, 3, warmup=1)
    for shards in TP_SHARDS:
        rules = {"w_up": 1, "w_down": 0}
        blocks = [shard_params_for_tp({"w_up": w_up, "w_down": w_down},
                                      i, shards, rules)
                  for i in range(shards)]
        up = torch.stack([blk["w_up"] for blk in blocks])
        down = torch.stack([blk["w_down"] for blk in blocks])
        out = tp_mlp(x, up, down)
        err = (out - want).abs().max().item()
        lim = TP_TOL + TP_TOL * want.abs().max().item()
        ms = cuda_ms(lambda: tp_mlp(x, up, down), 3, warmup=1)
        print(f"tp_mlp [{b},{t},{dm}] x [{dm},{4 * dm}] f32, {shards} shards, "
              f"vs the dense MLP: max_abs_err {err:.3e} tol {lim:.3e}; "
              f"{ms:.3f} ms, dense {dense_ms:.3f} ms")
        check(err <= lim, f"tp_mlp on {shards} shards off the dense MLP")
        res[f"tp_mlp_{shards}"] = dict(max_abs_err=err, tol=lim, ms=ms,
                                       dense_ms=dense_ms)
    return res


def phase_wire(torch, params):
    """The full-width params, on the card, through the v2 wire format and
    back, bit for bit; encode and decode timed on the host clock."""
    from vantage6_tpu_torch._tree import tree_leaves
    from vantage6_tpu_torch.common import serialization as ser

    leaves = tree_leaves(params)
    check(all(x.is_cuda for x in leaves), "the params are not on the card")
    n = sum(x.numel() for x in leaves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = ser.serialize(params, format="v2")
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = ser.deserialize(blob)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ser.deserialize(blob, writable=True)
    decode_writable_s = time.perf_counter() - t0
    got = tree_leaves(out)
    same = len(got) == len(leaves) and all(
        a.dtype == np.float32 and a.shape == tuple(b.shape)
        and np.array_equal(a.view(np.uint32),
                           b.cpu().numpy().view(np.uint32))
        for a, b in zip(got, leaves))
    res = dict(elements=n, bytes=len(blob), encode_s=encode_s,
               decode_s=decode_s, decode_writable_s=decode_writable_s,
               bit_identical=same)
    print(f"wire v2: {n} f32 params from the card, {len(blob)} bytes; "
          f"encode {1e3 * encode_s:.1f} ms, decode {1e3 * decode_s:.3f} ms "
          f"(zero-copy), {1e3 * decode_writable_s:.1f} ms (writable); "
          f"bit-identical {same}")
    check(same, "the params did not round-trip the v2 wire bit for bit")
    return res


# the shape the CUDA-core kernel serves (bf16 at head dim 8, below wgmma's
# k16 depth): the main path's batch, heads and sequence
D_CUDA_CORE = 8


def phase_times(fa, torch, dev):
    """Each tensor-core kernel at the main path's shape, [16, 8, 1024, 128]
    causal, in the dtype it serves, and the CUDA-core kernel (the kernel
    before it) on the same tensors, timed in turns: bf16 with the
    tensor-core kernel, f32 with the TF32x3 kernel. Then the CUDA-core
    kernel alone at the shape it serves, [16, 8, 1024, 8] bf16 causal.
    Returns {case: {variant: figures}}."""
    b, h, t, d = FULL["batch"], FULL["n_heads"], FULL["seq"], \
        FULL["d_model"] // FULL["n_heads"]
    g = torch.Generator(device=dev).manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {}
    for case, dtype, peak, tol, hd, variants in (
            ("bfloat16", torch.bfloat16, PEAK_BF16_FLOPS, BF16_TOL, d,
             ("cuda_core", MAIN_VARIANT["bfloat16"])),
            ("float32", torch.float32, PEAK_TF32_FLOPS, F32_TOL, d,
             ("cuda_core", MAIN_VARIANT["float32"])),
            ("bfloat16_d8", torch.bfloat16, PEAK_BF16_FLOPS, BF16_TOL,
             D_CUDA_CORE, ("cuda_core",))):
        name = str(dtype).removeprefix("torch.")
        scale = hd**-0.5
        shape = f"[{b},{h},{t},{hd}]"
        q, k, v = (torch.randn(b, h, t, hd, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        library_ms = cuda_ms(
            lambda: sdpa(q, k, v, is_causal=True, scale=scale), 20)
        bound_ms, bound_by = attention_bound(b, h, t, t, hd, 0, 0, True,
                                             q.element_size(), peak)
        group = {}
        for variant in variants:
            spec = fa.KERNELS[variant]
            out = fa.flash_forward_cuda(q, k, v, 0, 0, True, scale,
                                        variant=variant)
            err, lim = compare(fa, torch, out, q, k, v, 0, 0, True, scale,
                               variant, tol)
            print(f"{variant} vs plain at {shape} {name} causal: "
                  f"max_abs_err {err:.3e} tol {lim:.3e}")
            plain_ms = cuda_ms(
                lambda: fa.kernel_reference(q, k, v, 0, 0, True, scale,
                                            spec.block_q, spec.block_k),
                3, warmup=1)
            group[variant] = dict(dtype=name, shape=shape, max_abs_err=err,
                                  ms=[], plain_ms=plain_ms,
                                  library_ms=library_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)
        if dtype == torch.float32:
            # the least time of three TF32 passes at the TF32 peak
            group[variants[1]]["tf32x3_floor_ms"] = attention_bound(
                b, h, t, t, hd, 0, 0, True, 4, peak / TF32_PASSES)[0]
        # in turns: a, b, b, a (a, a for one variant)
        for variant in variants + variants[::-1]:
            group[variant]["ms"].append(cuda_ms(
                lambda: fa.flash_forward_cuda(q, k, v, 0, 0, True, scale,
                                              variant=variant), 20))
        for variant, r in group.items():
            r["ms_runs"], r["ms"] = r["ms"], sum(r["ms"]) / len(r["ms"])
            floor = (f", 3xTF32 floor {r['tf32x3_floor_ms']:.4f} ms"
                     if "tf32x3_floor_ms" in r else "")
            print(f"flash_attention_fwd {variant} {shape} {name} "
                  f"causal: kernel {r['ms']:.4f} ms (runs "
                  f"{r['ms_runs'][0]:.4f}, {r['ms_runs'][1]:.4f}), plain "
                  f"{r['plain_ms']:.4f} ms, sdpa {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}){floor}")
        res[case] = group
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
            return "f32 GEMMs (plain attention; the model's too in f32)"
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


# ------------------------------------------ phase 10: the task plane
# the FedAvg flagship (phase 6's config) driven the way a vantage6 user
# drives it: central_fedavg through Federation.create_task
TASK_PLANE = dict(rounds=5, fused_rounds=5, masked_station=5,
                  offline_station=7, host_workers=8, column=3, seed=0,
                  timed_runs=3)


def _host_moments(df):
    """A plain-Python partial over a dict of arrays: per-feature sums and
    sums of squares in float64, and the row count (no pandas)."""
    x = df["x"]
    return {"sum": np.sum(x, axis=0, dtype=np.float64).tolist(),
            "sumsq": np.sum(np.square(x, dtype=np.float64), axis=0).tolist(),
            "n": int(x.shape[0])}


def _profile_round(torch, fn, label):
    """One traced call of ``fn`` (a round): wall ms, the device's busy ms
    and kernel launches, and the host's 8 costliest functions by own time
    (cProfile, a second call)."""
    import cProfile
    import pstats

    wall_ms, rows = trace_device(torch, fn)
    busy_ms = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    host = sorted(((tt * 1e3, nc, f"{os.path.basename(fl)}:{ln}({name})")
                   for (fl, ln, name), (_, nc, tt, _, _) in stats.items()),
                  reverse=True)[:8]
    print(f"profiled {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%) in {launches} "
          f"launches; host own time:")
    for ms, n, name in host:
        print(f"  {ms:9.3f} ms {n:6d}x {name[:90]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, launches=launches,
                host_top=[dict(ms=m, calls=n, name=k) for m, n, k in host])


def phase_task_plane(fa, torch, dev, profile=False):
    """Phase 10: the task plane at full width. (a) a Federation built from
    FederationConfig.from_dict, one station per flagship shard; (b)
    central_fedavg for 5 rounds through create_task (central in host mode,
    partials in device mode) against 5 eager FedAvg.round calls; (c)
    run_fused_rounds with one station masked against engine.run_rounds;
    (d) central_average_device at the registry's size against float64
    numpy; (e) aggregate_stacked's three modes on one round's deltas with
    one station offline; (f) a host-mode task over dicts of arrays at 0 and
    8 executor workers; (g) a checkpoint round trip. No flash kernel may
    launch. With ``profile``, one traced runtime round and one eager round
    (device busy share, launches, the host's costliest functions)."""
    from vantage6_tpu_torch._tree import tree_leaves, tree_map
    from vantage6_tpu_torch.algorithm.decorators import data
    from vantage6_tpu_torch.core.config import FederationConfig
    from vantage6_tpu_torch.fed.collectives import fed_mean
    from vantage6_tpu_torch.optim import adam
    from vantage6_tpu_torch.runtime import checkpoint as ckpt
    from vantage6_tpu_torch.runtime.federation import (
        Federation,
        federation_from_datasets,
    )
    from vantage6_tpu_torch.utils.datasets import synthetic_image_classes
    from vantage6_tpu_torch.workloads import average
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    cfg, tp = FEDAVG, TASK_PLANE
    n_s, k, seed = cfg["stations"], tp["rounds"], tp["seed"]
    sync = torch.cuda.synchronize
    res, failed = {}, []

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    def engine(**kw):
        return W.make_engine(n_stations=n_s, device=dev,
                             local_steps=cfg["local_steps"],
                             batch_size=cfg["batch"], local_lr=cfg["lr"],
                             learning_stats=False, **kw)

    # the main path's counts start here
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    # (a) the federation from a config dict (no YAML)
    fed_cfg = FederationConfig.from_dict({
        "federation": {"name": "fedavg-flagship", "executor_workers": 0},
        "stations": [{"name": f"station_{i}", "organization": f"org_{i}",
                      "databases": [{"label": "default", "type": "array"}]}
                     for i in range(n_s)],
    })
    sx, sy, counts = W.make_federated_data(
        n_s, n_per_station=cfg["per_station"], alpha=cfg["alpha"], seed=0,
        noise=cfg["noise"])
    sx, sy, counts = (t.to(dev) for t in (sx, sy, counts))
    fed = Federation(fed_cfg, device=dev, algorithms={"fedavg": W})
    fed.set_datasets("default", [
        {"x": sx[i], "y": sy[i], "count": counts[i],
         "sid": torch.tensor(i, dtype=torch.int32, device=dev)}
        for i in range(n_s)])
    print(f"task plane: federation {fed_cfg.name!r} of {fed.n_stations} "
          f"stations on {fed.mesh.device}, executor_workers "
          f"{fed_cfg.resolved_executor_workers()}")

    # (b) central_fedavg through create_task, against eager engine rounds
    kw = dict(local_steps=cfg["local_steps"], batch_size=cfg["batch"],
              lr=cfg["lr"], seed=seed)

    def central(n_rounds):
        task = fed.create_task("fedavg", {"method": "central_fedavg",
                                          "kwargs": dict(kw, n_rounds=n_rounds)},
                               organizations=[0])
        (out,) = fed.wait_for_results(task.id)
        sync()
        return task, out

    eng = engine()
    params0 = W.init_params(seed, device=dev)

    def eager(n_rounds):
        """n_rounds eager engine rounds with central_fedavg's draws, each
        ended by a host pull of its loss (as central_fedavg's float())."""
        p, o, out_losses = params0, eng.init(params0), []
        for r in range(n_rounds):
            p, o, loss, _ = eng.round(p, o, sx, sy, counts,
                                      key=seed * 100003 + r)
            out_losses.append(loss.item())
        return p, out_losses

    def timed(fn):
        """(ms per round, peak GB, result) of fn(k), from a synchronised
        start with the peak reset."""
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        result = fn(k)
        sync()
        return (1e3 * (time.perf_counter() - t0) / k,
                torch.cuda.max_memory_allocated() / 1e9, result)

    central(1)  # warm-up: lazy library handles, allocator
    eager(1)
    # in turns: eager, runtime, runtime, eager
    e1_ms, eager_peak, (eager_params, eager_losses) = timed(eager)
    r1_ms, runtime_peak, (task, out) = timed(central)
    r2_ms, _, _ = timed(central)
    e2_ms, _, _ = timed(eager)
    runtime_ms, eager_ms = (r1_ms + r2_ms) / 2, (e1_ms + e2_ms) / 2
    # what the task records keep on the card: each round's stacked result
    retained_gb = sum(x.numel() * x.element_size()
                      for t in fed.tasks.values()
                      if t.stacked_result is not None
                      for x in tree_leaves(t.stacked_result)) / 1e9
    subtasks = [t for t in fed.tasks.values() if t.parent_id == task.id]
    gate(task.status.value == "completed" and len(subtasks) == k
         and all(len(t.runs) == n_s and t.is_finished for t in subtasks),
         "central_fedavg did not complete one 32-run subtask a round")
    err = _max_diff(torch, out["params"], eager_params)
    loss_err = max(abs(a - b) for a, b in zip(out["losses"], eager_losses))
    print(f"gate central_fedavg ({k} rounds through create_task) == {k} "
          f"eager FedAvg.round under sgd(1.0), same init and draws: params "
          f"max_abs_err {err:.3e}, losses {loss_err:.3e} (tolerance 0: the "
          f"same ops)")
    gate(err == 0 and loss_err == 0,
         "central_fedavg differs from eager engine rounds")
    losses = out["losses"]
    ex, ey = synthetic_image_classes(FEDAVG_EVAL["n"], seed=FEDAVG_EVAL["seed"],
                                     noise=FEDAVG_EVAL["noise"])
    acc = W.evaluate(out["params"], ex, ey)
    print(f"central_fedavg losses {[round(x, 4) for x in losses]}, accuracy "
          f"{acc:.4f}")
    gate(all(x == x for x in losses) and losses[-1] < losses[0],
         f"central_fedavg loss did not fall: {losses}")
    gate(acc > FEDAVG_MIN_ACCURACY,
         f"central_fedavg accuracy {acc} <= {FEDAVG_MIN_ACCURACY}")
    res["central_fedavg"] = dict(
        ms_per_round=runtime_ms, runtime_runs_ms=[r1_ms, r2_ms],
        eager_ms_per_round=eager_ms, eager_runs_ms=[e1_ms, e2_ms],
        peak_mem_gb=runtime_peak, eager_peak_mem_gb=eager_peak,
        retained_by_task_records_gb=retained_gb, losses=losses,
        accuracy=acc, max_abs_err=err)
    print(f"task plane round: {runtime_ms:.3f} ms/round through "
          f"create_task (runs {r1_ms:.3f}, {r2_ms:.3f}; central host run + "
          f"a device-mode subtask a round), engine eager round() "
          f"{eager_ms:.3f} ms/round (runs {e1_ms:.3f}, {e2_ms:.3f}), in "
          f"turns; peak {runtime_peak:.3f} GB (eager {eager_peak:.3f} GB); "
          f"task records hold {retained_gb:.3f} GB of stacked results "
          f"after {len(fed.tasks)} tasks")
    if profile:
        res["profile"] = {
            "runtime_round": _profile_round(torch, lambda: central(1),
                                            "runtime round (create_task)"),
            "eager_round": _profile_round(torch, lambda: eager(1),
                                          "engine eager round"),
        }

    # (c) run_fused_rounds with one station masked
    feng = engine()
    fed.mask_station(tp["masked_station"])
    kf = tp["fused_rounds"]
    first = fed.run_fused_rounds(feng, params0, sx, sy, counts, seed, kf)
    fused = fed.run_fused_rounds(feng, params0, sx, sy, counts, seed, kf)
    mask = fused["mask"]
    direct = feng.run_rounds(params0, sx, sy, counts, seed, kf, mask=mask)
    sync()
    err = max(_max_diff(torch, fused["params"], direct[0]),
              _max_diff(torch, fused["losses"], direct[2]),
              _max_diff(torch, first["params"], fused["params"]))
    print(f"gate run_fused_rounds (K = {kf}, station "
          f"{tp['masked_station']} masked) == engine.run_rounds with that "
          f"mask: max_abs_err {err:.3e} (tolerance 0); "
          f"{fused['rounds_per_sec']:.1f} rounds/s "
          f"({1e3 * fused['seconds'] / kf:.3f} ms/round, replayed)")
    gate(err == 0 and float(mask.sum()) == n_s - 1
         and mask[tp["masked_station"]].item() == 0,
         "run_fused_rounds differs from engine.run_rounds")
    fed.mask_station(tp["masked_station"], False)
    res["run_fused_rounds"] = dict(
        rounds_per_s=fused["rounds_per_sec"],
        ms_per_round=1e3 * fused["seconds"] / kf,
        first_dispatch_s=first["seconds"], max_abs_err=err)

    # (e) aggregate_stacked's modes on one round's deltas, one station down
    off = tp["offline_station"]
    fed.set_station_online(off, False)
    gen_u = torch.Generator(device=dev).manual_seed(7)
    draws = torch.rand((n_s, cfg["local_steps"], cfg["batch"]),
                       generator=gen_u, device=dev)
    rt = fed.create_task("fedavg", {
        "method": "partial_train", "args": [params0],
        "kwargs": dict(local_steps=cfg["local_steps"],
                       batch_size=cfg["batch"], lr=cfg["lr"], draws=draws)})
    gate(rt.runs[off].status.value == "pending"
         and rt.participation[off].item() == 0,
         "the offline station's run is not pending and masked")
    weights = rt.stacked_result["count"]
    agg = {m: fed.aggregate_stacked(rt, weights=weights, agg_mode=m)
           for m in ("replicated", "scattered", "scattered_bf16")}
    keep = [i for i in range(n_s) if i != off]
    others = fed_mean(tree_map(lambda x: x[keep], rt.stacked_result),
                      weights=weights[keep])
    def rel_err(a, b):
        """The worst leaf's max |a - b| over its largest |b|."""
        return max((x.float() - y.float()).abs().max().item()
                   / max(y.abs().max().item(), 1e-30)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    e_scat = _max_diff(torch, agg["scattered"], agg["replicated"])
    e_bf16 = rel_err(agg["scattered_bf16"], agg["replicated"])
    e_off = max(
        (x - y).abs().max().item() / max(z.abs().max().item(), 1e-30)
        for x, y, z in zip(tree_leaves(agg["replicated"]),
                           tree_leaves(others),
                           tree_leaves(rt.stacked_result)))
    # bf16 keeps 8 significant bits: the rounded sum is within 2^-9 of
    # each value; each leaf held to 2^-8 of its largest mean value
    lim_bf16 = 2.0**-8
    # an f32 sum of 31 or 32 weighted terms in another order: within 32
    # f32 roundings (2^-19) of the largest term, doubled
    lim_off = 2.0**-18
    print(f"gate aggregate_stacked on one round's CNN deltas (station {off} "
          f"offline): scattered vs replicated max_abs_err {e_scat:.3e} (tol "
          f"1e-5); scattered_bf16 vs replicated {e_bf16:.3e} of each leaf's "
          f"largest mean (tol 2^-8); replicated vs the mean over the other "
          f"{n_s - 1} {e_off:.3e} of each leaf's largest station value (tol "
          f"2^-18)")
    gate(e_scat <= 1e-5, "scattered aggregation differs from replicated")
    gate(e_bf16 <= lim_bf16, "scattered_bf16 aggregation out of tolerance")
    gate(e_off <= lim_off, "the offline station was not excluded")
    fed.set_station_online(off, True)  # drains the owed run
    gate(rt.participation.sum().item() == n_s and rt.is_finished,
         "the reconnected station's run did not drain")
    res["aggregate_stacked"] = dict(scattered_err=e_scat, bf16_rel_err=e_bf16,
                                    offline_rel_err=e_off)
    del fed, agg, others, rt

    # (d) central_average_device at the registry's size
    an = ANALYSIS
    g = torch.Generator(device=dev).manual_seed(an["seed"])
    reg = torch.randn((an["stations"], an["rows"], an["features"]),
                      generator=g, device=dev) * 10.0 + 50.0
    col = tp["column"]
    oracle = float(np.mean(reg[:, :, col].double().cpu().numpy(),
                           dtype=np.float64))
    afed = federation_from_datasets([{"x": reg[i]} for i in range(
        an["stations"])], {"avg": average}, device=dev, executor_workers=0)

    def avg_call():
        t = afed.create_task("avg", {"method": "central_average_device",
                                     "kwargs": {"column_index": col}},
                             organizations=[0])
        return afed.wait_for_results(t.id)[0]

    avg_ms, avg_runs, got = median_ms(torch, avg_call, tp["timed_runs"])
    rel = abs(got["average"] - oracle) / abs(oracle)
    print(f"gate central_average_device over {an['stations']} x "
          f"{an['rows']} x {an['features']} f32: average "
          f"{got['average']:.7f} vs float64 oracle {oracle:.7f}, relative "
          f"{rel:.2e} (tol 1e-6), count {got['count']}; {avg_ms:.3f} ms per "
          f"call (runs {[round(x, 3) for x in avg_runs]})")
    gate(rel <= 1e-6 and got["count"] == an["stations"] * an["rows"],
         "central_average_device disagrees with the float64 oracle")
    res["central_average_device"] = dict(ms=avg_ms, runs_ms=avg_runs,
                                         relative_err=rel)
    del afed

    # (f) a host-mode task over dicts of arrays, 0 and 8 executor workers
    host = [{"x": reg[i].cpu().numpy()} for i in range(an["stations"])]
    del reg
    partial = data(1)(_host_moments)
    host_res = {}
    for workers in (0, tp["host_workers"]):
        hfed = federation_from_datasets(host, {"host": {"moments": partial}},
                                        device=dev, executor_workers=workers)
        try:
            def host_call():
                t = hfed.create_task("host", {"method": "moments"})
                return t, hfed.wait_for_results(t.id)

            ms, runs, (t, results) = median_ms(torch, host_call,
                                               tp["timed_runs"])
            timing = hfed.task_timing(t.id)
        finally:
            hfed.close()
        host_res[workers] = dict(ms=ms, runs_ms=runs, results=results,
                                 sum_exec_s=timing["sum_exec_s"],
                                 max_exec_s=timing["max_exec_s"],
                                 straggler_station=timing["straggler_station"])
        print(f"host task at executor_workers={workers}: {ms:.3f} ms per "
              f"round (runs {[round(x, 3) for x in runs]}); task_timing sum "
              f"{1e3 * timing['sum_exec_s']:.3f} ms, max "
              f"{1e3 * timing['max_exec_s']:.3f} ms, straggler station "
              f"{timing['straggler_station']}")
    seq, pool = host_res[0], host_res[tp["host_workers"]]
    gate(seq["results"] == pool["results"]
         and len(seq["results"]) == an["stations"],
         "pooled host results differ from sequential ones")
    gate(all(r["sum_exec_s"] >= r["max_exec_s"] > 0
             and 0 <= r["straggler_station"] < an["stations"]
             for r in host_res.values()), "task_timing is incomplete")
    res["host"] = {str(w): {k2: v for k2, v in r.items() if k2 != "results"}
                   for w, r in host_res.items()}

    # (g) a checkpoint round trip: params, Adam state, generator state
    aeng = engine(server_optimizer=adam(1e-3))
    gen = torch.Generator(device=dev).manual_seed(11)

    def adam_rounds(p, o, g, n):
        for _ in range(n):
            p, o, _, _ = aeng.round(p, o, sx, sy, counts, g)
        return p, o

    p2, o2 = adam_rounds(params0, aeng.init(params0), gen, 2)
    saved_rng = gen.get_state()
    ck_dir = os.path.join(HERE, "chiprun_out", "task_plane_ckpt")
    mgr = ckpt.CheckpointManager(ck_dir)
    try:
        mgr.save(ckpt.TrainState(p2, o2, 2, gen))
        straight = adam_rounds(p2, o2, gen, 2)[0]
        back = mgr.restore(device=dev)
    finally:
        import shutil

        shutil.rmtree(ck_dir, ignore_errors=True)
    bit = (_max_diff(torch, back.params, p2) == 0
           and _max_diff(torch, back.opt_state.mu, o2.mu) == 0
           and _max_diff(torch, back.opt_state.nu, o2.nu) == 0
           and int(back.opt_state.count) == int(o2.count)
           and torch.equal(back.rng_state, saved_rng)
           and all(x.device == p2["Dense_1"]["kernel"].device
                   for x in tree_leaves(back.params)))
    resumed = adam_rounds(back.params, back.opt_state,
                          back.generator(dev), 2)[0]
    err = _max_diff(torch, resumed, straight)
    print(f"gate checkpoint round trip (params, Adam state, generator "
          f"state): bit-identical {bit}; 2 rounds after the restore vs 2 "
          f"uninterrupted: max_abs_err {err:.3e} (tolerance 0)")
    gate(bit, "the checkpoint round trip is not bit-identical")
    gate(err == 0, "rounds after a restore differ from uninterrupted ones")
    res["checkpoint"] = dict(bit_identical=bit, resume_err=err)

    torch.backends.cudnn.deterministic = deterministic
    sync()
    launches = dict(fa.flash_forward_cuda.variant_launches)
    res["launches"] = launches
    print(f"task plane flash launches: {launches} (0 expected: FedAvg's "
          f"CNN and the collectives)")
    gate(sum(launches.values()) == 0,
         f"the task plane launched a flash kernel: {launches}")
    check(not failed, "task plane gates failed: " + "; ".join(failed))
    return res


# ------------------------------- phase 11: the observed, compressed planes
# phase 6's flagship and phase 10's Federation with the reference's
# compression config; the learning plane and the device observatory
PLANES = dict(tasks=2, rounds=5, fused_rounds=5, seed=3, timed_turns=2,
              rows_cut=2)
PLANES_REL_TOL = 1e-6   # the mean of the decoded deltas vs fed_mean(hats)
LEARNING_REL_TOL = 1e-5  # recorded station stats vs a float64 recompute
MIN_WIRE_REDUCTION = 4.0  # the reference's bar (bench.py:2634)


def _host_station_stats(torch, stacked, weights):
    """float64 numpy station norms and cosines of one round's stacked
    result, flat-packed as the learning record packs it (every leaf, in
    sorted-key order), weighted by ``weights``."""
    from vantage6_tpu_torch.fed.collectives import flatten_stacked

    x = flatten_stacked(stacked).double().cpu().numpy()
    w = weights.double().cpu().numpy()
    norms = np.sqrt(np.sum(x * x, axis=1))
    pooled = (w[:, None] * x).sum(axis=0) / w.sum()
    gnorm = np.sqrt(np.sum(pooled * pooled))
    cos = (x @ pooled) / np.maximum(norms * gnorm, 1e-12)
    return x.shape, norms, cos


def phase_planes(fa, torch, dev):
    """Phase 11: the three host planes on phase 6's flagship and phase
    10's Federation, built from FederationConfig.from_dict with the
    reference's compression config. (a) a host-mode task whose partial
    trains its station's CNN delta on the card and returns
    client.compress_update(delta), twice, the central decompressing each
    payload through the v2 wire; (b) central_fedavg's rounds aggregated
    through client.aggregate_stacked, through create_task with
    learning_stats on, and FedAvg.attach_history over run_rounds;
    (c) the device observatory's compile, dispatch and retrace events and
    a profile window around one fused round; (d) the flight recorder's
    dump. No flash kernel may launch."""
    from vantage6_tpu_torch._tree import tree_leaves, tree_map
    from vantage6_tpu_torch.algorithm.context import current_environment
    from vantage6_tpu_torch.algorithm.decorators import algorithm_client, data
    from vantage6_tpu_torch.common.flight import FLIGHT, read_bundle
    from vantage6_tpu_torch.common.serialization import (
        deserialize,
        serialize,
    )
    from vantage6_tpu_torch.core.config import FederationConfig
    from vantage6_tpu_torch.fed import compression as C
    from vantage6_tpu_torch.fed.collectives import fed_mean
    from vantage6_tpu_torch.fed.fedavg import indices_from_uniform, local_sgd
    from vantage6_tpu_torch.runtime import profiling as P
    from vantage6_tpu_torch.runtime.federation import Federation
    from vantage6_tpu_torch.runtime.tracing import TRACER
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    cfg, pl = FEDAVG, PLANES
    n_s, seed = cfg["stations"], pl["seed"]
    sync = torch.cuda.synchronize
    res, failed = {}, []

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    FLIGHT.clear()
    sx, sy, counts = W.make_federated_data(
        n_s, n_per_station=cfg["per_station"], alpha=cfg["alpha"], seed=0,
        noise=cfg["noise"])
    sx, sy, counts = (t.to(dev) for t in (sx, sy, counts))
    params0 = W.init_params(seed, device=dev)
    deltas, compress_s, seqs, drawn = {}, [], {}, []

    @data(1)
    def partial_compressed(df, params, draws):
        """One station's local SGD on the card, its delta compressed with
        the station's error feedback for the uplink."""
        env = current_environment()
        sid = int(df["sid"])
        idx = indices_from_uniform(draws[sid], df["count"])
        delta, _ = local_sgd(W.weighted_ce_loss, df["x"], df["y"], idx,
                             params, cfg["lr"])
        deltas[sid] = delta
        sync()
        t0 = time.perf_counter()
        out = env.client.compress_update(delta)
        compress_s.append(time.perf_counter() - t0)
        seqs[sid] = drawn[-1]  # the stations run one after another
        return out

    @algorithm_client
    def central_compressed(client, params, draws):
        """Fan out, then carry each payload over the v2 wire, decompress
        it and take the mean of the dense deltas."""
        orgs = [o["id"] for o in client.organization.list()]
        task = client.task.create(
            input_={"method": "partial_compressed",
                    "kwargs": {"params": params, "draws": draws}},
            organizations=orgs, name="compressed_uplink")
        payloads = client.wait_for_results(task["id"])
        t = {"encode": [], "decode": [], "decompress": []}
        frames, dense = [], []
        for p in payloads:
            t0 = time.perf_counter()
            blob = serialize(p, format="v2")
            t1 = time.perf_counter()
            back = deserialize(blob)
            t2 = time.perf_counter()
            dense.append(client.decompress_update(back))
            sync()
            t3 = time.perf_counter()
            t["encode"].append(t1 - t0)
            t["decode"].append(t2 - t1)
            t["decompress"].append(t3 - t2)
            frames.append(len(blob))
        stacked = tree_map(lambda *xs: torch.stack(xs), *dense)
        return {"task": task["id"], "dense": dense, "frames": frames,
                "seconds": t, "mean": fed_mean(stacked)}

    fed_cfg = FederationConfig.from_dict({
        "federation": {"name": "fedavg-planes", "executor_workers": 0,
                       "compression": dict(COMPRESSOR)},
        "stations": [{"name": f"station_{i}", "organization": f"org_{i}",
                      "databases": [{"label": "default", "type": "array"}]}
                     for i in range(n_s)],
    })
    @algorithm_client
    def central_learning(client, n_rounds):
        """central_fedavg's rounds (its init, its draws, its partial_train),
        each aggregated through client.aggregate_stacked with the counts as
        weights: the call that records a round into the learning plane."""
        params = W.init_params(seed, device=client.device)
        orgs = [o["id"] for o in client.organization.list()]
        shape = (len(orgs), cfg["local_steps"], cfg["batch"])
        losses = []
        for r in range(n_rounds):
            gen = torch.Generator(device=client.device).manual_seed(
                seed * 100003 + r)
            task = client.task.create(
                input_={"method": "partial_train", "args": [params],
                        "kwargs": {"local_steps": cfg["local_steps"],
                                   "batch_size": cfg["batch"],
                                   "lr": cfg["lr"],
                                   "draws": torch.rand(
                                       shape, generator=gen,
                                       device=client.device)}},
                organizations=orgs, name=f"round_{r}")
            stacked, _ = client.wait_for_stacked_result(task["id"])
            mean = client.aggregate_stacked(task["id"],
                                            weights=stacked["count"])
            params = tree_map(lambda p, d: p + d, params, mean["delta"])
            losses.append(float(mean["loss"]))
        return {"params": params, "losses": losses}

    fed = Federation(fed_cfg, device=dev, algorithms={
        "planes": {"partial_compressed": partial_compressed,
                   "central_compressed": central_compressed,
                   "partial_train": W.partial_train,
                   "central_learning": central_learning}})
    fed.set_datasets("default", [
        {"x": sx[i], "y": sy[i], "count": counts[i],
         "sid": torch.tensor(i, dtype=torch.int32, device=dev)}
        for i in range(n_s)])
    dc = fed._delta_compressor
    spec = dc.spec
    # the replay below needs each exchange's number: record the numbers
    # the compressor makes its noise generators for
    exchange_generator = dc.generator

    def recording_generator(seq, device):
        drawn.append(seq)
        return exchange_generator(seq, device)

    dc.generator = recording_generator
    print(f"planes: federation {fed_cfg.name!r} of {fed.n_stations} stations "
          f"on {fed.mesh.device}, compressor {spec}")

    # (a) the compressed host-plane exchange, 2 tasks
    n_params = sum(x.numel() for x in tree_leaves(params0))
    ef_before, outs, hats = {}, [], []
    for t in range(pl["tasks"]):
        names = [f"{i}:update" for i in range(n_s)]
        ef_prev = {k: dc._ef[k].clone() if k in dc._ef else None
                   for k in names}
        ef_before[t] = ef_prev
        gen = torch.Generator(device=dev).manual_seed(seed * 1000 + t)
        draws = torch.rand((n_s, cfg["local_steps"], cfg["batch"]),
                           generator=gen, device=dev)
        compress_s.clear()
        task = fed.create_task("planes", {
            "method": "central_compressed",
            "kwargs": {"params": params0, "draws": draws}},
            organizations=[0])
        (out,) = fed.wait_for_results(task.id)
        out["compress_s"] = list(compress_s)
        outs.append(out)
        # replay each station's exchange with compress_delta from its
        # pre-task EF and its exchange's generator: the hats the payloads
        # must decode to, and the EF the store must hold
        bad_hat = bad_ef = bad_store = 0
        t_hats = []
        for i, name in enumerate(names):
            flat = C.flatten_host(deltas[i])
            ef = ef_prev[name]
            _, hat, new_ef = C.compress_delta(
                spec, flat, ef, key=exchange_generator(seqs[i], dev))
            acc = flat if ef is None else flat + ef
            bad_hat += not torch.equal(C.flatten_host(out["dense"][i]), hat)
            bad_ef += not torch.equal(new_ef, acc - hat)
            bad_store += not torch.equal(dc._ef[name], new_ef)
            t_hats.append(hat)
        hats.append(torch.stack(t_hats))
        want = fed_mean(hats[-1])
        got = C.flatten_host(out["mean"])
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"gate compressed exchange, task {t + 1}: decoded dense delta "
              f"== compress_delta's hat bit for bit at {n_s - bad_hat} of "
              f"{n_s} stations; new_ef == acc - hat exactly at "
              f"{n_s - bad_ef}; EF store == new_ef at {n_s - bad_store}; "
              f"mean of the decoded deltas vs fed_mean(hats) {rel:.3e} "
              f"relative (tol {PLANES_REL_TOL:g})")
        gate(bad_hat == 0, f"task {t + 1}: a decoded delta is not its hat")
        gate(bad_ef == 0, f"task {t + 1}: new_ef != acc - hat")
        gate(bad_store == 0, f"task {t + 1}: the EF store != new_ef")
        gate(rel <= PLANES_REL_TOL, f"task {t + 1}: mean off by {rel}")
        sub = fed.get_task(out["task"])
        out["result_wire_bytes"] = [r.result_wire_bytes for r in sub.runs]
    moved = sum(not torch.equal(dc._ef[f"{i}:update"],
                                ef_before[1][f"{i}:update"])
                for i in range(n_s))
    gate(moved == n_s, f"the EF store advanced at {moved} of {n_s} stations")
    raw = 4 * n_params * n_s
    wire = sum(outs[-1]["frames"])
    reduction = raw / wire
    sec = outs[-1]["seconds"]
    comp = 1e3 * np.asarray([s for o in outs for s in o["compress_s"]])
    decomp = 1e3 * np.asarray([s for o in outs
                               for s in o["seconds"]["decompress"]])
    # medians: each task's first calls pay lazy library set-up
    comp_ms, decomp_ms = float(np.median(comp)), float(np.median(decomp))
    enc_ms, dec_ms = 1e3 * sum(sec["encode"]), 1e3 * sum(sec["decode"])
    print(f"gate EF store advanced between the tasks at {moved} of {n_s} "
          f"stations; wire reduction {reduction:.3f}x ({raw} raw f32 bytes "
          f"/ {wire} v2 frame bytes for {n_s} stations; bar "
          f"{MIN_WIRE_REDUCTION}x; run records' result_wire_bytes "
          f"{min(outs[-1]['result_wire_bytes'])}-"
          f"{max(outs[-1]['result_wire_bytes'])})")
    gate(reduction >= MIN_WIRE_REDUCTION, f"reduction {reduction} < "
         f"{MIN_WIRE_REDUCTION}")
    print(f"compressed exchange: compress_update {comp_ms:.3f} ms per "
          f"station, decompress_update {decomp_ms:.3f} ms per payload "
          f"(medians over {pl['tasks']} x {n_s}; means {comp.mean():.3f} "
          f"and {decomp.mean():.3f}, first calls {comp[0]:.3f} and "
          f"{decomp[0]:.3f}); the last task's v2 encode {enc_ms:.3f} ms and "
          f"decode {dec_ms:.3f} ms for the {n_s} payloads")
    res["compressed_exchange"] = dict(
        reduction=reduction, raw_bytes=raw, wire_bytes=wire,
        result_wire_bytes=outs[-1]["result_wire_bytes"],
        compress_update_ms=comp_ms, decompress_update_ms=decomp_ms,
        compress_update_mean_ms=float(comp.mean()),
        decompress_update_mean_ms=float(decomp.mean()),
        compress_update_first_ms=float(comp[0]),
        encode_ms=enc_ms, decode_ms=dec_ms)
    del outs, hats, deltas, ef_before

    # (b) the learning plane: central_learning with learning_stats on
    k = pl["rounds"]

    def central(n_rounds=k):
        task = fed.create_task("planes", {
            "method": "central_learning",
            "kwargs": {"n_rounds": n_rounds}}, organizations=[0])
        (out,) = fed.wait_for_results(task.id)
        sync()
        return task, out

    central(1)  # warm-up
    task, out = central()
    hist = fed.learning_history(task.id)
    gate(hist is not None and hist.rounds_total == k,
         f"learning history holds {None if hist is None else hist.rounds_total}"
         f" rounds, not {k}")
    subs = sorted((t for t in fed.tasks.values() if t.parent_id == task.id),
                  key=lambda t: t.id)
    errs = [0.0, 0.0]
    for rec, sub in zip(hist.rounds(), subs):
        shape, norms, cos = _host_station_stats(
            torch, sub.stacked_result,
            sub.stacked_result["count"] * sub.participation)
        for j, (got, want) in enumerate(((rec["station_norms"], norms),
                                         (rec["station_cos"], cos))):
            errs[j] = max(errs[j], float(
                np.max(np.abs(np.asarray(got) - want))
                / np.max(np.abs(want))))
    print(f"gate learning plane: {hist.rounds_total} rounds recorded for "
          f"central_learning's task {task.id} ({len(subs)} subtasks); station "
          f"norms {errs[0]:.3e} and cosines {errs[1]:.3e} relative to a "
          f"float64 numpy recompute over the pulled {list(shape)} stacked "
          f"results ({n_params} delta params, the count and the loss; tol "
          f"{LEARNING_REL_TOL:g})")
    gate(max(errs) <= LEARNING_REL_TOL, f"learning stats off by {errs}")
    gate(len(subs) == k, f"{len(subs)} subtasks, not {k}")

    def turn(on):
        fed.config.learning_stats = on
        t0 = time.perf_counter()
        central()
        return 1e3 * (time.perf_counter() - t0) / k

    runs = {True: [], False: []}
    for on in (False, True, True, False) * (pl["timed_turns"] // 2):
        runs[on].append(turn(on))
    fed.config.learning_stats = True
    on_ms, off_ms = float(np.mean(runs[True])), float(np.mean(runs[False]))
    print(f"runtime round (central_learning, aggregate_stacked) with "
          f"learning_stats on {on_ms:.3f} ms (runs "
          f"{[round(x, 3) for x in runs[True]]}), off {off_ms:.3f} ms (runs "
          f"{[round(x, 3) for x in runs[False]]}), in turns: the record "
          f"costs {on_ms - off_ms:.3f} ms a round (its [{n_s}, "
          f"{shape[1]}] pull is {4 * n_s * shape[1] / 1e6:.1f} MB)")

    eng = W.make_engine(n_stations=n_s, device=dev,
                        local_steps=cfg["local_steps"],
                        batch_size=cfg["batch"], local_lr=cfg["lr"])
    kf = pl["fused_rounds"]
    ehist = eng.attach_history("planes.engine")
    _, _, losses, stats = eng.run_rounds(params0, sx, sy, counts, seed, kf)
    recs = ehist.rounds()
    same = len(recs) == kf and all(
        rec["update_norm"] == float(stats["update_norm"][r])
        and rec["station_norms"] == stats["station_norm"][r].tolist()
        and rec["station_cos"] == stats["station_cos"][r].tolist()
        and rec["station_weights"] == stats["station_weight"][r].tolist()
        and rec["loss"] == float(losses[r])
        for r, rec in enumerate(recs))
    print(f"gate attach_history: {len(recs)} rounds recorded from one "
          f"run_rounds (K = {kf}), equal to the returned stats exactly: "
          f"{same}")
    gate(same, "the engine's history differs from its returned stats")

    def fused(attached):
        eng.attach_history(ehist if attached else None)
        sync()
        t0 = time.perf_counter()
        eng.run_rounds(params0, sx, sy, counts, seed, kf)
        sync()
        return 1e3 * (time.perf_counter() - t0) / kf

    fruns = {True: [], False: []}
    for attached in (False, True, True, False):
        fruns[attached].append(fused(attached))
    eng.attach_history(None)
    f_on, f_off = float(np.mean(fruns[True])), float(np.mean(fruns[False]))
    print(f"fused round (run_rounds K = {kf}) with a history attached "
          f"{f_on:.3f} ms (runs {[round(x, 3) for x in fruns[True]]}), "
          f"without {f_off:.3f} ms (runs "
          f"{[round(x, 3) for x in fruns[False]]}), in turns")
    res["learning"] = dict(
        rounds=hist.rounds_total, norm_rel_err=errs[0], cos_rel_err=errs[1],
        runtime_on_ms=on_ms, runtime_off_ms=off_ms,
        runtime_on_runs=runs[True], runtime_off_runs=runs[False],
        fused_attached_ms=f_on, fused_detached_ms=f_off,
        engine_history_equal=same)
    del eng

    # (c) the device observatory on a fresh engine's fused runs
    oeng = W.make_engine(n_stations=n_s, device=dev,
                         local_steps=cfg["local_steps"],
                         batch_size=cfg["batch"], local_lr=cfg["lr"],
                         learning_stats=False)
    rows = sx.shape[1] // pl["rows_cut"]
    cut = (sx[:, :rows].contiguous(), sy[:, :rows].contiguous(),
           counts.clamp(max=rows))

    def compiles(trace_id):
        return [s for s in TRACER.drain(trace_id)
                if s["name"] == "device.compile"]

    obs = {}
    for name, (x, y, c) in (("first", (sx, sy, counts)),
                            ("same", (sx, sy, counts)),
                            ("rows_cut", cut)):
        d0 = oeng._run.stats()["dispatches"]
        with TRACER.span("smoke.observatory", kind="smoke",
                         attrs={"call": name}) as root:
            oeng.run_rounds(params0, x, y, c, seed, kf)
            sync()
            trace_id = root.context.trace_id
        obs[name] = dict(spans=[s["attrs"] for s in compiles(trace_id)],
                         dispatched=oeng._run.stats()["dispatches"] - d0)
    first, same_sig, cut_sig = obs["first"], obs["same"], obs["rows_cut"]
    sp = first["spans"][0] if first["spans"] else {}
    print(f"gate observatory: first run_rounds of its signature -> "
          f"{len(first['spans'])} device.compile span (warm-up "
          f"{sp.get('warmup_ms')} ms, capture {sp.get('capture_ms')} ms, "
          f"{sp.get('capture_allocated_bytes')} bytes allocated, "
          f"{sp.get('capture_reserved_bytes')} reserved); same signature "
          f"-> {len(same_sig['spans'])} spans, {same_sig['dispatched']} "
          f"dispatch counted")
    gate(len(first["spans"]) == 1 and sp.get("capture_ms") is not None
         and sp.get("capture_allocated_bytes") is not None,
         f"the first call's compile spans: {first['spans']}")
    gate(len(same_sig["spans"]) == 0 and same_sig["dispatched"] == 1,
         f"the same signature compiled again or was not counted: {same_sig}")
    cs = cut_sig["spans"][0] if cut_sig["spans"] else {}
    changed = cs.get("changed", "")
    print(f"gate retrace: {rows} rows per station instead of "
          f"{sx.shape[1]} -> {len(cut_sig['spans'])} compile span, retrace "
          f"{cs.get('retrace')}, changed {changed!r}; engine's "
          f"fedavg.run_rounds: {oeng._run.stats()['retraces']} retrace, "
          f"{oeng._run.stats()['compiles']} compiles")
    gate(len(cut_sig["spans"]) == 1 and cs.get("retrace") is True
         and oeng._run.stats()["retraces"] == 1
         and changed.startswith("[0][1]: ")
         and f"[{n_s},{sx.shape[1]}," in changed
         and f"[{n_s},{rows}," in changed,
         f"the rows cut is not one retrace naming the leaf: {cut_sig}")
    prof_dir = os.path.join(HERE, "chiprun_out", "planes_profile")
    window = P.profile_window(log_dir=prof_dir, run=lambda: oeng.run_rounds(
        params0, sx, sy, counts, seed, 1))
    kernels = P.trace_kernel_events(window["trace"])
    noted = any(n.get("kind") == "profile_window"
                and n.get("trace") == window["trace"]
                for n in FLIGHT.recent_notes(limit=10_000))
    print(f"gate profile_window around one fused round: "
          f"{window['seconds'] * 1e3:.3f} ms, {kernels} CUDA kernel events "
          f"in {os.path.relpath(window['trace'], HERE)}, noted in FLIGHT "
          f"{noted}")
    gate(kernels > 0 and noted, "the profile window holds no kernels or "
         "was not noted")
    res["observatory"] = dict(
        warmup_ms=sp.get("warmup_ms"), capture_ms=sp.get("capture_ms"),
        capture_allocated_bytes=sp.get("capture_allocated_bytes"),
        capture_reserved_bytes=sp.get("capture_reserved_bytes"),
        retrace_changed=changed, profile_kernel_events=kernels,
        profile_ms=window["seconds"] * 1e3)
    del oeng

    # (d) the flight recorder
    bundle = read_bundle(FLIGHT.dump(
        os.path.join(HERE, "chiprun_out", "planes_flight.jsonl"),
        reason="chip_smoke"))
    learning = [r for r in bundle if r["type"] == "learning"
                and r.get("task") == task.id]
    retraces = [r for r in bundle if r["type"] == "note"
                and r.get("kind") == "retrace"
                and r.get("function") == "fedavg.run_rounds"]
    print(f"gate flight dump: {len(bundle)} records, learning records of "
          f"task {task.id}: {len(learning)}, retrace notes of "
          f"fedavg.run_rounds: {len(retraces)}")
    gate(learning and retraces, "the dump lacks the learning record or the "
         "retrace note")
    fed.close()
    del fed

    sync()
    launches = dict(fa.flash_forward_cuda.variant_launches)
    res["launches"] = launches
    print(f"planes flash launches: {launches} (0 expected: the CNN, the "
          f"compressor and the host planes)")
    gate(sum(launches.values()) == 0,
         f"the planes launched a flash kernel: {launches}")
    check(not failed, "planes gates failed: " + "; ".join(failed))
    return res


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


# --------------------------- phase 12: the parity ladder's tasks on the card
# rungs 2, 4 and 5 of BASELINE.md's parity ladder (federated logistic
# regression, Cox, Kaplan-Meier with a secure sum) and the summary, at a
# registry's size: phase 8's 32 stations of up to 65,536 patients (ragged)
# and 16 covariates, ten years of follow-up in integer weeks; then the host
# centrals of phase 8's programs at phase 8's sizes
WORKLOADS = dict(stations=ANALYSIS["stations"], rows=ANALYSIS["rows"],
                 features=ANALYSIS["features"], weeks=520, hazard_scale=200.0,
                 logit_bias=0.2, logreg_iter=100, logreg_lr=1.0,
                 logreg_host_iter=10, cox_iter=10, cox_host_iter=3,
                 secure_key=0x5EC0_00D5_1A7E_0001, workers=8,
                 row_cats=ANALYSIS["row_cats"], col_cats=ANALYSIS["col_cats"],
                 min_cell_count=ANALYSIS["min_cell_count"],
                 quantiles=ANALYSIS["quantiles"],
                 vertical_stations=ANALYSIS["vertical_stations"],
                 vertical_rows=ANALYSIS["vertical_rows"],
                 vertical_host_iter=3, vertical_lr=1.0, seed=12)
# 100 f32 GD steps against float64 GD; each gradient an f32 sum over ~2.1M
# rows (as VERTICAL_ATOL's over 262,144)
LOGREG_ATOL = 2e-4
# the host central's 10 f32 steps against fit_device's 10: the same
# per-station gradients summed in another order (numpy f32 across
# stations), ~1e-6 a step
LOGREG_HOST_ATOL = 2e-5
# f32 Newton on sums over ~2.1M rows against float64 Newton: a relative
# sqrt(N) x 2^-24 ~ 1e-4 of the gradient's terms, over a Hessian of the
# same scale, moves beta by ~1e-5
COX_BETA_ATOL = 1e-4
# f32 column sums over 65,536-row stations: sqrt(65,536) x 2^-24 of E|x|
# (~0.8) for the mean, doubled; the std's ss / n - mean^2 the same
SUMMARY_ATOL = 2e-5
# float64 sums of ~2.1M values in another order: 2.1M x 2^-53 < 2.4e-10
SUMMARY_HOST_ATOL = 1e-9
COX_MAX_PEAK_GB = 40.0  # well under the [S, K, n, d] einsum's 69.8 GB


def _numpy_logreg(x, y, n_iter, lr):
    """Pooled full-batch GD on the logistic NLL in float64 (the oracle)."""
    w, b = np.zeros(x.shape[1]), 0.0
    for _ in range(n_iter):
        r = 1 / (1 + np.exp(-(x @ w + b))) - y
        w = w - lr * (x.T @ r) / len(y)
        b = b - lr * np.sum(r) / len(y)
    return w, b


def _numpy_cox(x, t, e, grid, n_iter, ridge=1e-6):
    """Pooled Breslow Newton in float64 (the oracle), with the port's
    ridge: rows grouped by time, each risk-set sum a reverse cumulative
    sum over the groups (no [K, n] matrix). Returns (beta, the last
    gradient, the per-component budget of its f32 terms)."""
    order = np.argsort(t, kind="stable")
    xs, ts, es = x[order], t[order], e[order]
    times, starts = np.unique(ts, return_index=True)
    ends = np.append(starts[1:], len(ts))
    pos = np.searchsorted(times, grid)
    d = np.add.reduceat(es, starts)[pos]
    s = np.add.reduceat(xs * es[:, None], starts)[pos]
    beta = np.zeros(x.shape[1])
    for _ in range(n_iter):
        w = np.exp(xs @ beta)
        xw = xs * w[:, None]
        g0 = np.add.reduceat(w, starts)
        g1 = np.add.reduceat(xw, starts)
        g2 = np.stack([xw[a:b].T @ xs[a:b] for a, b in zip(starts, ends)])
        # at risk at g_k: every row whose time is >= g_k
        s0, s1, s2 = (np.cumsum(g[::-1], axis=0)[::-1][pos]
                      for g in (g0, g1, g2))
        mean = s1 / s0[:, None]
        grad = np.sum(s - d[:, None] * mean, axis=0)
        cov = s2 / s0[:, None, None] - mean[:, :, None] * mean[:, None, :]
        hess = -np.sum(d[:, None, None] * cov, axis=0) - ridge * np.eye(
            len(beta))
        terms = np.sum(np.abs(s) + d[:, None] * np.abs(mean), axis=0)
        beta = beta - np.linalg.solve(hess, grad)
    return beta, grad, terms


def _profile_call(torch, fn, label, ms):
    """One traced call of ``fn``: the device's busy share over the untraced
    call's ``ms``, launches, and the costliest kernels."""
    wall_ms, rows = trace_device(torch, fn)
    check(bool(rows), f"the profiler recorded no device time for {label}")
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)

    def kind(name):
        if "gemm" in name or "gemv" in name:
            return "GEMMs and GEMVs (f32, CUDA cores)"
        if "reduce_kernel" in name:
            return "reductions"
        return "elementwise and copies"

    groups: dict[str, float] = {}
    for k_ms, _, name in rows:
        groups[kind(name)] = groups.get(kind(name), 0.0) + k_ms
    print(f"profiled {label}: wall {wall_ms:.3f} ms traced, device busy "
          f"{busy:.3f} ms in {launches} launches ({100 * busy / ms:.1f}% of "
          f"the untraced {ms:.3f} ms)")
    for name, g_ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g_ms:9.3f} ms {100 * g_ms / busy:5.1f}%  {name}")
    for k_ms, n, name in rows[:8]:
        print(f"  {k_ms:9.3f} ms {n:6d}x {name[:90]}")
    return dict(traced_wall_ms=wall_ms, device_busy_ms=busy,
                launches=launches, busy_share_untraced=busy / ms,
                groups=groups,
                top=[dict(ms=m, count=n, name=k) for m, n, k in rows[:12]])


def _registry(cfg, torch, dev):
    """Phase 12's registry (module doc), drawn from ``cfg["seed"]``: the
    generator (for later draws), per-station row counts, the ``[S, n]``
    row mask and the padded covariates, event times, event flags and
    logistic labels (zero past each station's count)."""
    rng = np.random.default_rng(cfg["seed"])
    n_s, n, p = cfg["stations"], cfg["rows"], cfg["features"]
    counts, mask_np, _ = _ragged(rng, cfg, torch, dev)
    keep = mask_np.astype(bool)
    x = rng.standard_normal((n_s, n, p)).astype(np.float32)
    x[~keep] = 0.0
    beta_star = np.linspace(-0.5, 0.5, p)
    rate = np.exp(x.astype(np.float64) @ beta_star) / cfg["hazard_scale"]
    t_event = rng.exponential(1.0 / rate)
    t_cens = rng.uniform(0.0, cfg["weeks"], size=(n_s, n))
    time_ = np.ceil(np.minimum(np.minimum(t_event, t_cens),
                               cfg["weeks"])).astype(np.float32)
    event = (t_event <= t_cens).astype(np.float32)
    w_star = rng.normal(size=p) * 0.3
    prob = 1 / (1 + np.exp(-(x.astype(np.float64) @ w_star
                             + cfg["logit_bias"])))
    label = (rng.uniform(size=(n_s, n)) < prob).astype(np.float32)
    for a in (time_, event, label):
        a[~keep] = 0.0
    return rng, counts, keep, x, time_, event, label


def phase_workloads(fa, torch, dev, profile=False):
    """Phase 12: the parity ladder's tasks through ``Federation.create_task``
    at a registry's size, each held to a float64 numpy oracle (or to its
    device twin), with ms per call (median of 3, synchronised) and peak
    memory: ``fit_device`` and ``central_logistic``; ``kaplan_meier_device``
    plain and secure, ``central_kaplan_meier``; ``fit_cox_device`` and
    ``central_cox``; ``summary_device`` and ``central_summary``; the host
    centrals of phase 8's programs. No flash kernel may launch. With
    ``profile``, one traced call of ``fit_cox_device`` and ``fit_device``."""
    from vantage6_tpu_torch.runtime.federation import federation_from_datasets
    from vantage6_tpu_torch.workloads import glm, quantiles, stats, vertical
    from vantage6_tpu_torch.workloads import logistic_regression as LR
    from vantage6_tpu_torch.workloads import summary as SM
    from vantage6_tpu_torch.workloads import survival as SV

    cfg = WORKLOADS
    n_s, n, p = cfg["stations"], cfg["rows"], cfg["features"]
    res, failed = {}, []
    features = [f"f{j}" for j in range(p)]

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    def timed(name, fn, warmup=1):
        torch.cuda.reset_peak_memory_stats()
        ms, runs, result = median_ms(torch, fn, warmup=warmup)
        res[name] = dict(ms=ms, runs_ms=runs,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        return result

    # the main path's counts start here
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)

    # ------------------------------------------------------------- the data
    rng, counts, keep, x, time_, event, label = _registry(cfg, torch, dev)
    tx, tt, te, ty = (torch.from_numpy(a).to(dev)
                      for a in (x, time_, event, label))
    tc = torch.from_numpy(counts.astype(np.float32)).to(dev)
    device_data = [{"x": tx[i], "y": ty[i], "time": tt[i], "event": te[i],
                    "count": tc[i]} for i in range(n_s)]
    host_data = []
    for i in range(n_s):
        c = int(counts[i])
        cols = {f: x[i, :c, j].astype(np.float64)
                for j, f in enumerate(features)}
        cols.update(time=time_[i, :c].astype(np.float64),
                    event=event[i, :c].astype(np.float64),
                    y=label[i, :c].astype(np.float64))
        host_data.append(cols)
    px, pt, pe, py = (a[keep].astype(np.float64)
                      for a in (x, time_, event, label))
    big_n = len(py)
    grid = np.unique(pt[pe > 0])
    print(f"workloads: {n_s} stations, {big_n} patients (ragged up to {n}),"
          f" {p} covariates, {int(pe.sum())} events on a grid of "
          f"{len(grid)} weeks")
    images = {"logreg": LR, "survival": SV, "summary": SM}
    dfed = federation_from_datasets(device_data, images, device=dev,
                                    executor_workers=0)
    hfed = federation_from_datasets(
        host_data, dict(images, glm=glm, quantiles=quantiles, stats=stats),
        device=dev, executor_workers=cfg["workers"])

    def central(image, method, **kwargs):
        task = hfed.create_task(image, {"method": method, "kwargs": kwargs},
                                organizations=[0])
        (out,) = hfed.wait_for_results(task.id)
        return out

    # ------------------------------------- rung 2: logistic regression
    out = timed("fit_device", lambda: LR.fit_device(
        dfed, p, n_iter=cfg["logreg_iter"], lr=cfg["logreg_lr"]))
    w_ref, b_ref = _numpy_logreg(px, py, cfg["logreg_iter"],
                                 cfg["logreg_lr"])
    err = max(float(np.abs(out["w"][:, 0].cpu().numpy() - w_ref).max()),
              abs(float(out["b"][0]) - b_ref))
    res["fit_device"].update(max_abs_err=err, tol=LOGREG_ATOL,
                             iterations=cfg["logreg_iter"])
    print(f"gate fit_device ({cfg['logreg_iter']} iterations) vs float64 "
          f"numpy GD: max_abs_err {err:.3e} (tol {LOGREG_ATOL})")
    gate(err <= LOGREG_ATOL, f"fit_device off float64 GD by {err}")
    k = cfg["logreg_host_iter"]
    host = timed("central_logistic", lambda: central(
        "logreg", "central_logistic", feature_cols=features, label_col="y",
        n_iter=k, lr=cfg["logreg_lr"]), warmup=0)
    dev_k = LR.fit_device(dfed, p, n_iter=k, lr=cfg["logreg_lr"])
    err = max(float(np.abs(host["w"] - dev_k["w"].cpu().numpy()).max()),
              float(np.abs(host["b"] - dev_k["b"].cpu().numpy()).max()))
    res["central_logistic"].update(max_abs_err=err, tol=LOGREG_HOST_ATOL,
                                   iterations=k, n=host["n_samples"])
    print(f"gate central_logistic ({k} iterations, host) vs fit_device at "
          f"{k}: max_abs_err {err:.3e} (tol {LOGREG_HOST_ATOL})")
    gate(err <= LOGREG_HOST_ATOL and host["n_samples"] == big_n,
         f"central_logistic off fit_device by {err}")

    # ------------------------------------ rungs 4-5: Kaplan-Meier
    events_ref = np.asarray([np.sum(pe[pt == g]) for g in grid])
    sorted_t = np.sort(pt)
    at_risk_ref = (big_n - np.searchsorted(sorted_t, grid, side="left")
                   ).astype(np.float64)
    surv_ref = np.cumprod(1.0 - events_ref / at_risk_ref)
    km_tol = 3 * len(grid) * 2.0**-24
    plain = timed("kaplan_meier_device", lambda: SV.kaplan_meier_device(
        dfed, grid))
    secure = timed("kaplan_meier_device_secure",
                   lambda: SV.kaplan_meier_device(
                       dfed, grid, secure=True, key=cfg["secure_key"]))
    for name, r in (("kaplan_meier_device", plain),
                    ("kaplan_meier_device_secure", secure)):
        exact = (np.array_equal(r["events"], events_ref)
                 and np.array_equal(r["at_risk"], at_risk_ref))
        err = float(np.abs(r["survival"] - surv_ref).max())
        res[name].update(counts_exact=exact, survival_max_abs_err=err,
                         survival_tol=km_tol, grid=len(grid))
        print(f"gate {name}: counts == numpy integer counts {exact}; "
              f"survival vs float64 cumprod max_abs_err {err:.3e} (tol "
              f"{km_tol:.3e} = 3 x {len(grid)} x 2^-24)")
        gate(exact, f"{name} counts differ from numpy's")
        gate(err <= km_tol, f"{name} survival off by {err}")
    gate(np.array_equal(secure["survival"], plain["survival"]),
         "secure KM differs from plain KM")
    host = timed("central_kaplan_meier", lambda: central(
        "survival", "central_kaplan_meier", time_col="time",
        event_col="event"), warmup=0)
    exact = (host["time"] == grid.tolist()
             and host["events"] == events_ref.tolist()
             and host["at_risk"] == at_risk_ref.tolist()
             and host["survival"] == surv_ref.tolist())
    res["central_kaplan_meier"].update(exact=exact)
    print(f"gate central_kaplan_meier (host): grid, counts and survival == "
          f"numpy float64 {exact} (exact)")
    gate(exact, "central_kaplan_meier differs from numpy")

    # ---------------------------------------------------------- rung 4: Cox
    out = timed("fit_cox_device", lambda: SV.fit_cox_device(
        dfed, p, grid, n_iter=cfg["cox_iter"]))
    beta_ref, grad_ref, terms = _numpy_cox(px, pt, pe, grid,
                                           cfg["cox_iter"])
    err = float(np.abs(out["beta"] - beta_ref).max())
    gn_ref = float(np.linalg.norm(grad_ref))
    # f32 sums over N rows: sqrt(N) roundings of 2^-24 of the gradient's
    # terms
    gn_tol = float(np.linalg.norm(terms) * np.sqrt(big_n) * 2.0**-24)
    peak = res["fit_cox_device"]["peak_mem_gb"]
    res["fit_cox_device"].update(
        max_abs_err=err, tol=COX_BETA_ATOL, grad_norm=out["grad_norm"],
        grad_norm_ref=gn_ref, grad_norm_tol=gn_tol, beta=out["beta"].tolist(),
        iterations=cfg["cox_iter"])
    print(f"gate fit_cox_device ({cfg['cox_iter']} Newton steps) vs float64 "
          f"numpy Breslow Newton: beta max_abs_err {err:.3e} (tol "
          f"{COX_BETA_ATOL}); grad norm {out['grad_norm']:.4e} vs "
          f"{gn_ref:.4e} (tol {gn_tol:.4e} = sqrt(N) x 2^-24 of its terms); "
          f"peak {peak:.3f} GB (limit {COX_MAX_PEAK_GB})")
    gate(err <= COX_BETA_ATOL, f"fit_cox_device beta off by {err}")
    gate(abs(out["grad_norm"] - gn_ref) <= gn_tol,
         f"fit_cox_device grad norm {out['grad_norm']} vs {gn_ref}")
    gate(peak < COX_MAX_PEAK_GB, f"fit_cox_device peaked at {peak} GB")
    k = cfg["cox_host_iter"]
    host = timed("central_cox", lambda: central(
        "survival", "central_cox", feature_cols=features, time_col="time",
        event_col="event", n_iter=k), warmup=0)
    dev_k = SV.fit_cox_device(dfed, p, grid, n_iter=k)
    err = float(np.abs(np.asarray(host["beta"]) - dev_k["beta"]).max())
    gn_err = abs(host["grad_norm"] - dev_k["grad_norm"])
    res["central_cox"].update(max_abs_err=err, tol=COX_BETA_ATOL,
                              grad_norm=host["grad_norm"],
                              grad_norm_device=dev_k["grad_norm"],
                              iterations=k)
    print(f"gate central_cox ({k} Newton steps, host) vs fit_cox_device at "
          f"{k}: beta max_abs_err {err:.3e} (tol {COX_BETA_ATOL}); grad norm"
          f" {host['grad_norm']:.4e} vs {dev_k['grad_norm']:.4e} (tol 1e-3 "
          f"relative + {gn_tol:.4e})")
    gate(err <= COX_BETA_ATOL and host["event_times"] == grid.tolist(),
         f"central_cox off fit_cox_device by {err}")
    gate(gn_err <= 1e-3 * dev_k["grad_norm"] + gn_tol,
         f"central_cox grad norm {host['grad_norm']} vs "
         f"{dev_k['grad_norm']}")
    if profile:
        res["profile"] = {
            "fit_cox_device": _profile_call(
                torch, lambda: SV.fit_cox_device(dfed, p, grid,
                                                 n_iter=cfg["cox_iter"]),
                "fit_cox_device", res["fit_cox_device"]["ms"]),
            "fit_device": _profile_call(
                torch, lambda: LR.fit_device(dfed, p,
                                             n_iter=cfg["logreg_iter"],
                                             lr=cfg["logreg_lr"]),
                "fit_device", res["fit_device"]["ms"]),
        }

    # --------------------------------------------------------------- summary
    ref = dict(count=big_n, mean=px.mean(0), std=px.std(0, ddof=1),
               min=px.min(0), max=px.max(0))
    got = timed("summary_device", lambda: SM.summary_device(dfed))
    err = max(float(np.abs(got[k2] - ref[k2]).max()) for k2 in ("mean",
                                                               "std"))
    exact = (int(got["count"]) == big_n
             and np.array_equal(got["min"], ref["min"])
             and np.array_equal(got["max"], ref["max"]))
    res["summary_device"].update(max_abs_err=err, tol=SUMMARY_ATOL,
                                 count_min_max_exact=exact)
    print(f"gate summary_device vs numpy float64: mean/std max_abs_err "
          f"{err:.3e} (tol {SUMMARY_ATOL}); count, min, max exact {exact}")
    gate(err <= SUMMARY_ATOL and exact, "summary_device off numpy")
    got = timed("central_summary", lambda: central(
        "summary", "central_summary", columns=features), warmup=0)
    err = max(float(abs(got[f][k2] - ref[k2][j]))
              for j, f in enumerate(features) for k2 in ("mean", "std"))
    exact = all(got[f]["count"] == big_n and got[f]["min"] == ref["min"][j]
                and got[f]["max"] == ref["max"][j]
                for j, f in enumerate(features))
    res["central_summary"].update(max_abs_err=err, tol=SUMMARY_HOST_ATOL,
                                  count_min_max_exact=exact)
    print(f"gate central_summary (host) vs numpy float64: mean/std "
          f"max_abs_err {err:.3e} (tol {SUMMARY_HOST_ATOL}); count, min, max"
          f" exact {exact}")
    gate(err <= SUMMARY_HOST_ATOL and exact, "central_summary off numpy")
    del dfed, device_data, tx, tt, te, ty

    # ---------------- the host centrals of phase 8's programs, its sizes
    design = np.concatenate([np.ones((big_n, 1)), px], axis=1)
    beta_true = rng.normal(size=p + 1) * 0.1
    eta = design @ beta_true
    glm_y = {
        "gaussian": eta + rng.normal(0, 0.5, eta.shape),
        "binomial": (rng.uniform(size=eta.shape)
                     < 1 / (1 + np.exp(-eta))).astype(np.float64),
        "poisson": rng.poisson(np.exp(eta)).astype(np.float64),
    }
    lab = np.exp(rng.normal(4.0, 0.5, size=big_n)).astype(np.float32)
    r_p = rng.dirichlet(np.full(cfg["row_cats"], 0.5))
    c_p = rng.dirichlet(np.full(cfg["col_cats"], 0.5))
    rc = rng.choice(cfg["row_cats"], size=big_n, p=r_p)
    cc = rng.choice(cfg["col_cats"], size=big_n, p=c_p)
    edges = np.concatenate([[0], np.cumsum(counts)])
    for i, frame in enumerate(host_data):
        rows = slice(edges[i], edges[i + 1])
        frame.update({f"y_{fam}": y[rows] for fam, y in glm_y.items()})
        frame.update(lab=lab[rows].astype(np.float64), row_cat=rc[rows],
                     col_cat=cc[rows])
    for family, y in glm_y.items():
        got = timed(f"central_glm_{family}", lambda: central(
            "glm", "central_glm", family=family, feature_cols=features,
            label_col=f"y_{family}"), warmup=0)
        ref = _numpy_irls(family, design, y)
        beta = np.asarray(got["coefficients"])
        err = float(np.abs(beta - ref).max())
        ok = (np.allclose(beta, ref, rtol=GLM_RTOL, atol=GLM_ATOL)
              and got["converged"] and got["count"] == big_n)
        res[f"central_glm_{family}"].update(
            max_abs_err=err, rtol=GLM_RTOL, atol=GLM_ATOL,
            iterations=got["iterations"], converged=got["converged"])
        print(f"gate central_glm {family} (host, float64 on the card) vs "
              f"numpy IRLS: max_abs_err {err:.3e} (rtol {GLM_RTOL}, atol "
              f"{GLM_ATOL}), {got['iterations']} iterations, converged "
              f"{got['converged']}")
        gate(ok, f"central_glm {family} off numpy IRLS by {err}")
    pooled_lab = np.sort(lab)
    for q in cfg["quantiles"]:
        got = timed(f"central_quantile_{q}", lambda: central(
            "quantiles", "central_quantile", column="lab", q=q, tol=0.0),
            warmup=0)
        rank = float(pooled_lab[int(np.ceil(q * big_n)) - 1])
        res[f"central_quantile_{q}"].update(
            value=got["value"], rank_value=rank,
            task_rounds=got["task_rounds"])
        print(f"gate central_quantile {q} (host, 64 bisection rounds): "
              f"{got['value']!r} vs the rank value {rank!r} (exact), "
              f"{got['task_rounds']} task rounds")
        gate(got["value"] == rank and got["n"] == big_n,
             f"central_quantile {q}: {got['value']} != {rank}")
    got = timed("central_crosstab", lambda: central(
        "stats", "central_crosstab", row_col="row_cat", col_col="col_cat",
        min_cell_count=cfg["min_cell_count"]), warmup=0)
    total: dict = {}
    for i in range(n_s):
        rows = slice(edges[i], edges[i + 1])
        pairs, nums = np.unique(np.stack([rc[rows], cc[rows]]), axis=1,
                                return_counts=True)
        for (r, c), m in zip(pairs.T.tolist(), nums.tolist()):
            key = (str(r), str(c))
            poisoned = m < cfg["min_cell_count"] or total.get(key, 0) is None
            total[key] = None if poisoned else total.get(key, 0) + m
    rows_s = sorted({r for r, _ in total})
    cols_s = sorted({c for _, c in total})
    expect = [[total.get((r, c), 0) for c in cols_s] for r in rows_s]
    exact = (got["rows"] == rows_s and got["columns"] == cols_s
             and got["table"] == expect)
    res["central_crosstab"].update(exact=exact, poisoned_cells=sum(
        v is None for row in expect for v in row))
    print(f"gate central_crosstab (host): table == pooled counts with the "
          f"poisoning rule {exact} (exact)")
    gate(exact, "central_crosstab differs from the pooled counts")
    got = timed("central_correlation", lambda: central(
        "stats", "central_correlation", columns=features), warmup=0)
    err = float(np.abs(np.asarray(got["matrix"]) - np.corrcoef(px.T)).max())
    res["central_correlation"].update(max_abs_err=err, tol=CORR_ATOL)
    print(f"gate central_correlation (host) vs np.corrcoef: max_abs_err "
          f"{err:.3e} (tol {CORR_ATOL})")
    gate(err <= CORR_ATOL and got["n"] == big_n,
         f"central_correlation off np.corrcoef by {err}")
    hfed.close()
    del hfed, host_data

    vs, vn = cfg["vertical_stations"], cfg["vertical_rows"]
    xv = rng.standard_normal((vs, vn, p))
    w_true = rng.normal(size=(vs, p)) * 0.3
    yv = (rng.uniform(size=vn) < 1 / (1 + np.exp(
        -(np.einsum("snp,sp->n", xv, w_true) - 0.2)))).astype(np.float64)
    names = [[f"v{s}_{j}" for j in range(p)] for s in range(vs)]
    frames = [{c: xv[s, :, j] for j, c in enumerate(names[s])}
              for s in range(vs)]
    frames[0]["y"] = yv
    vfed = federation_from_datasets(frames, {"vertical": vertical},
                                    device=dev, executor_workers=vs)
    k = cfg["vertical_host_iter"]
    try:
        def vcall():
            task = vfed.create_task("vertical", {
                "method": "central_vertical_logistic", "kwargs": dict(
                    feature_map={str(s): c for s, c in enumerate(names)},
                    label_org=0, label_col="y", n_iter=k,
                    lr=cfg["vertical_lr"])}, organizations=[0])
            return vfed.wait_for_results(task.id)[0]

        got = timed("central_vertical_logistic", vcall, warmup=0)
    finally:
        vfed.close()
    xcat = np.concatenate(list(xv), axis=1)
    w_ref, b_ref = _numpy_logreg(xcat, yv, k, cfg["vertical_lr"])
    w_got = np.concatenate([got["weights"][str(s)] for s in range(vs)])
    err = max(float(np.abs(w_got - w_ref).max()), abs(got["bias"] - b_ref))
    res["central_vertical_logistic"].update(
        max_abs_err=err, tol=VERTICAL_ATOL, iterations=k,
        ms_per_iteration=res["central_vertical_logistic"]["ms"] / k)
    print(f"gate central_vertical_logistic (host, {vs} x {vn}, {k} "
          f"iterations) vs numpy pooled GD: max_abs_err {err:.3e} (tol "
          f"{VERTICAL_ATOL})")
    gate(err <= VERTICAL_ATOL, f"central_vertical_logistic off by {err}")

    launches = dict(fa.flash_forward_cuda.variant_launches)
    print(f"workloads flash launches: {launches} (0 expected: products, "
          f"reductions and the secure sum's masks)")
    gate(sum(launches.values()) == 0,
         f"the workloads launched a flash kernel: {launches}")
    for name, r in res.items():
        if name == "profile":
            continue
        extra = {k2: v for k2, v in r.items()
                 if k2 not in ("ms", "runs_ms", "peak_mem_gb", "beta")}
        print(f"workload {name}: {r['ms']:.3f} ms per call (median of 3; "
              f"runs {[round(v, 3) for v in r['runs_ms']]}), peak "
              f"{r['peak_mem_gb']:.3f} GB, {extra}")
    check(not failed, "workload gates failed: " + "; ".join(failed))
    return dict(config=cfg, programs=res, launches=launches)

# phase 13: one flagship round's sizes (phase 6) and one hospital's
# registry extract (phase 8's station of 65,536 patients, 16 covariates)
DISTRIBUTED = dict(stations=FEDAVG["stations"], rows=65536, features=16,
                   rounds=5, local_steps=4, lr=0.5, seed=13)
DIST_MEAN_RTOL = 1e-5  # the two-rank CPU test's tolerances for the stats
DIST_STD_RTOL = 1e-4
# f32 logistic fit against the float64 replay: 20 GD steps over 65,536
# rows, each gradient a sum whose f32 rounding is ~1e-6 relative
DIST_LOGREG_ATOL = 2e-5
# scattered_bf16 rounds the model to bf16 each round; the device's f32
# and the replay's float64 can round to neighbouring bf16 values: two bf16
# ulps (2^-7 each below 2) of the weights
DIST_LOGREG_BF16_ATOL = 2 * 2.0**-7


def _engine_station(i):
    """Station ``i``'s columns for phase 13's device-engine tasks (a dict
    of numpy columns, as a process loads only its own): ``age`` N(50, 10)
    and 16 N(0, 1) covariates with logistic labels. Returns (columns,
    feature names)."""
    cfg = DISTRIBUTED
    rng = np.random.default_rng(cfg["seed"] + i)
    n, p = cfg["rows"], cfg["features"]
    x = rng.standard_normal((n, p)).astype(np.float32)
    w_star = np.linspace(-1.0, 1.0, p)
    prob = 1 / (1 + np.exp(-(x.astype(np.float64) @ w_star + 0.2)))
    features = [f"f{j}" for j in range(p)]
    cols = {"age": rng.normal(50.0, 10.0, n),
            "label": (rng.uniform(size=n) < prob).astype(np.float64),
            **{f: x[:, j] for j, f in enumerate(features)}}
    return cols, features


def _replay_logistic(stations, rounds, local_steps, lr, bf16):
    """float64 replay of ``device_logistic_fit`` over ``stations`` (a list
    of (x, y)): each round every station's local steps from the global
    model with the reference's subgradients (at a logit of exactly 0 the
    loss's slope is -y, not 0.5 - y: ``jnp.maximum`` splits, ``jnp.abs``
    takes slope 1), then the row-count-weighted mean, rounded to bf16 with
    ``bf16`` as the wire does."""
    import torch

    p = stations[0][0].shape[1]
    w, b = np.zeros(p), 0.0
    total = sum(len(y) for _, y in stations)
    for _ in range(rounds):
        merged_w, merged_b = np.zeros(p), 0.0
        for x, y in stations:
            lw, lb = w, b
            for _ in range(local_steps):
                z = x @ lw + lb
                r = np.where(z == 0, -y, 1 / (1 + np.exp(-z)) - y)
                lw = lw - lr * (x.T @ r) / len(y)
                lb = lb - lr * np.sum(r) / len(y)
            merged_w = merged_w + len(y) / total * lw
            merged_b = merged_b + len(y) / total * lb
        w, b = merged_w, merged_b
        if bf16:
            w = (torch.tensor(w, dtype=torch.float32).to(torch.bfloat16)
                 .double().numpy())
            b = float(torch.tensor(b, dtype=torch.float32)
                      .to(torch.bfloat16))
    return w, b


def _engine_checks(stations, stats, fits):
    """Phase 13's gates on one run of the device engine over ``stations``
    (a list of ``_engine_station`` outputs): the column stats against
    float64 numpy, each ``agg_mode``'s fit against the float64 replay.
    Returns the errors, each beside its tolerance."""
    cfg = DISTRIBUTED
    age = np.concatenate([c["age"].astype(np.float32).astype(np.float64)
                          for c, _ in stations])
    out = dict(rel_err_mean=abs(stats["mean"] - age.mean()) / abs(age.mean()),
               rel_err_std=abs(stats["std"] - age.std()) / age.std())
    check(stats["count"] == age.size
          and out["rel_err_mean"] <= DIST_MEAN_RTOL
          and out["rel_err_std"] <= DIST_STD_RTOL
          and stats["n_stations"] == len(stations)
          and stats["global_devices"] == len(stations),
          f"device_column_stats off numpy: {stats}")
    xy = [(np.stack([c[f] for f in feats], 1).astype(np.float64), c["label"])
          for c, feats in stations]
    for mode, fit in fits.items():
        w_ref, b_ref = _replay_logistic(xy, cfg["rounds"], cfg["local_steps"],
                                        cfg["lr"], bf16=mode.endswith("bf16"))
        err = max(np.max(np.abs(np.asarray(fit["weights"]) - w_ref)),
                  abs(fit["bias"] - b_ref))
        tol = (DIST_LOGREG_BF16_ATOL if mode.endswith("bf16")
               else DIST_LOGREG_ATOL)
        check(err <= tol, f"device_logistic_fit {mode} off the float64 "
                          f"replay: {err:.3e} > {tol:.3e}")
        out[mode] = dict(max_abs_err=err, tol=tol,
                         local_accuracy=fit["local_accuracy"])
    return out


AGG_MODES = ("replicated", "scattered", "scattered_bf16")

# one rank of phase 13's two-rank gloo run on the card: joins the group
# with torch.distributed itself (initialize() picks NCCL for a card) and
# runs the device engine's tasks on its own station only
_GLOO_RANK = """
import json, sys
import torch
import torch.distributed as dist
rank, world, init, here, device = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
sys.path.insert(0, here)
import chip_smoke as cs
cs.DISTRIBUTED.update(json.loads(sys.argv[6]))  # the parent's sizes
from vantage6_tpu_torch.core import distributed as D
from vantage6_tpu_torch.workloads import device_engine as DE
dist.init_process_group("gloo", init_method=init, world_size=world,
                        rank=rank)
cfg = cs.DISTRIBUTED
cols, features = cs._engine_station(rank)
out = {"backend": D.backend(), "stats": DE.device_column_stats.__wrapped__(
    cols, "age", pad_to=cfg["rows"], device=device)}
for mode in cs.AGG_MODES:
    out[mode] = DE.device_logistic_fit.__wrapped__(
        cols, features, "label", rounds=cfg["rounds"],
        local_steps=cfg["local_steps"], batch_rows=cfg["rows"], lr=cfg["lr"],
        agg_mode=mode, device=device)
dist.destroy_process_group()
print(json.dumps(out))
"""


def _gloo_two_ranks(dev, timeout=300):
    """Phase 13's device-engine tasks over two gloo ranks on ``dev`` (both
    on the one card): each rank a child process with its own station.
    Returns (each rank's results, wall seconds); a rank that fails or
    outlives ``timeout`` fails the phase, and every child is stopped."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _GLOO_RANK, str(r), "2", init, HERE,
             dev.type, json.dumps(DISTRIBUTED)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
    for p, (out, err) in zip(procs, outs):
        check(p.returncode == 0, f"a gloo rank failed: {err[-2000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs], wall


def phase_distributed(fa, torch, dev):
    """Phase 13 (module doc): the multi-process layer on a process group
    of one rank on ``dev`` (NCCL on the card; gloo when rehearsed on the
    CPU)."""
    import socket

    from vantage6_tpu_torch.core import distributed as D
    from vantage6_tpu_torch.core.mesh import FederationMesh
    from vantage6_tpu_torch.fed.collectives import fed_mean_scattered_tree
    from vantage6_tpu_torch.fed.fedavg import local_sgd
    from vantage6_tpu_torch.parallel import ring_attention_sharded, tp_mlp
    from vantage6_tpu_torch.parallel.ring_attention import (
        ring_attention as ring_per_rank)
    from vantage6_tpu_torch.workloads import device_engine as DE
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    cfg, fcfg = DISTRIBUTED, FEDAVG
    res = {}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(V6T_COORDINATOR=f"127.0.0.1:{port}", V6T_NUM_PROCESSES="1",
               V6T_PROCESS_ID="0")
    os.environ.update(env)
    # the main path's counts start here
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    try:
        multi = D.initialize(device=dev)
        backend = D.backend()
        want = "nccl" if dev.type == "cuda" else "gloo"
        check(multi is False and D.is_initialized() and backend == want
              and D.process_count() == 1 and D.process_index() == 0,
              f"initialize: multi {multi}, backend {backend}, world "
              f"{D.process_count()}")
        nccl = (".".join(map(str, torch.cuda.nccl.version()))
                if dev.type == "cuda" else None)
        res["group"] = dict(backend=backend, nccl=nccl, world_size=1,
                            device=str(D.rank_device()))
        print(f"distributed: joined a {backend} group of 1 rank on "
              f"{D.rank_device()} (NCCL {nccl})")

        # -------------------------------------------- mesh and local shards
        n_s = cfg["stations"]
        gmesh = D.global_mesh(n_s)
        plain = FederationMesh(n_s, device=dev)
        check(gmesh.group is not None and gmesh.world_size == 1
              and gmesh.station_axis_size == 1
              and D.local_stations(gmesh) == list(range(n_s)),
              f"global mesh layout {gmesh!r}")
        shards = {s: np.full((3,), s, np.float32) for s in range(n_s)}
        stacked = D.stack_local_shards(gmesh, shards)
        check(tuple(stacked.shape) == (n_s, 3) and stacked.device == dev
              and stacked[:, 0].tolist() == list(range(n_s)),
              "stack_local_shards")

        # ------------------------------ the scattered mean over CNN deltas
        eng_plain = W.make_engine(plain, local_steps=fcfg["local_steps"],
                                  batch_size=fcfg["batch"],
                                  local_lr=fcfg["lr"])
        eng_group = W.make_engine(gmesh, local_steps=fcfg["local_steps"],
                                  batch_size=fcfg["batch"],
                                  local_lr=fcfg["lr"])
        sx, sy, counts = W.make_federated_data(
            n_s, n_per_station=fcfg["per_station"], alpha=fcfg["alpha"],
            seed=0, mesh=plain, noise=fcfg["noise"])
        params0 = W.init_params(1, device=dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        idx = eng_plain.draw_batch_indices(counts, gen)[0]
        with torch.no_grad():
            deltas, _ = plain.fed_map(
                lambda x, y, i, p: local_sgd(W.weighted_ce_loss, x, y, i, p,
                                             fcfg["lr"]),
                sx, sy, idx, replicated_args=(params0,), batched=True)
        n_flat = sum(v.numel() for v in _leaves(params0))
        scattered = {}
        for name, comm in (("f32", None), ("bf16", torch.bfloat16)):
            one = fed_mean_scattered_tree(plain, deltas, weights=counts,
                                          comm_dtype=comm)
            grp = fed_mean_scattered_tree(gmesh, deltas, weights=counts,
                                          comm_dtype=comm)
            same = all(torch.equal(a, b) for a, b in zip(
                _leaves(one), _leaves(grp), strict=True))
            check(same, f"fed_mean_scattered_tree ({name} comm) through "
                        f"{backend} differs from the one-card form")
            times = {"one_card": [], backend: []}
            for which in ("one_card", backend, backend, "one_card") * 2:
                m = plain if which == "one_card" else gmesh
                times[which].append(cuda_ms(
                    lambda m=m, c=comm: fed_mean_scattered_tree(
                        m, deltas, weights=counts, comm_dtype=c), 10)
                    if dev.type == "cuda" else 0.0)
            scattered[name] = dict(bit_identical=same, **{
                f"{k}_ms": sorted(v)[0] for k, v in times.items()},
                runs_ms=times)
            print(f"fed_mean_scattered_tree [{n_s}, {n_flat}] {name} comm: "
                  f"{backend} form == one-card form bit for bit; "
                  f"{scattered[name][backend + '_ms']:.4f} ms vs one-card "
                  f"{scattered[name]['one_card_ms']:.4f} ms (CUDA events, "
                  f"best of 4 turns of 10; turns {times})")
        res["scattered"] = dict(shape=[n_s, n_flat], **scattered)
        del deltas

        # -------------------- one eager flagship round on the group mesh
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            outs = {}
            for which, eng in (("plain", eng_plain), (backend, eng_group)):
                outs[which] = eng.round(params0, eng.init(params0), sx, sy,
                                        counts, batch_idx=idx)
            a, b = outs["plain"], outs[backend]
            same = (all(torch.equal(x, y) for x, y in zip(
                _leaves(a[0]), _leaves(b[0]), strict=True))
                and torch.equal(a[2], b[2])
                and all(torch.equal(a[3][k], b[3][k]) for k in a[3]))
            check(same, f"the eager round on the {backend} mesh differs "
                        "from the plain mesh's")
            round_ms = {"plain": [], backend: []}
            for which in ("plain", backend, backend, "plain"):
                eng = eng_plain if which == "plain" else eng_group
                state = [params0, eng.init(params0)]

                def one_round(eng=eng, state=state):
                    state[:] = eng.round(*state, sx, sy, counts,
                                         batch_idx=idx)[:2]

                round_ms[which].append(median_ms(torch, one_round, 3)[0])
        finally:
            torch.backends.cudnn.deterministic = deterministic
        res["fedavg_round"] = dict(
            bit_identical=same, loss=float(a[2]),
            ms={k: sorted(v)[0] for k, v in round_ms.items()},
            runs_ms=round_ms)
        print(f"fedavg eager round on the {backend} mesh == plain mesh bit "
              f"for bit (loss {float(a[2]):.6f}); ms/round {backend} "
              f"{res['fedavg_round']['ms'][backend]:.3f}, plain "
              f"{res['fedavg_round']['ms']['plain']:.3f} (best of 2 turns, "
              f"each the median of 3)")
        del sx, sy, outs, a, b, eng_plain, eng_group

        # --------------------------------------- the device engine's tasks
        cols, features = _engine_station(0)
        engine = {}

        def timed(name, fn):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            ms, runs, out = median_ms(torch, fn)
            engine[name] = dict(ms=ms, runs_ms=runs, peak_mem_gb=(
                torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else None))
            return out

        n = cfg["rows"]
        stats = timed("device_column_stats", lambda: DE.device_column_stats
                      .__wrapped__(cols, "age", pad_to=n))
        check(stats["process_index"] == 0, "process_index")
        fits = {mode: timed(
            f"device_logistic_fit_{mode}",
            lambda mode=mode: DE.device_logistic_fit.__wrapped__(
                cols, features, "label", rounds=cfg["rounds"],
                local_steps=cfg["local_steps"], batch_rows=n, lr=cfg["lr"],
                agg_mode=mode)) for mode in AGG_MODES}
        errors = _engine_checks([(cols, features)], stats, fits)
        for name, r in engine.items():
            print(f"device engine {name}: {r['ms']:.3f} ms per call (median "
                  f"of 3; runs {[round(v, 3) for v in r['runs_ms']]}), peak "
                  f"{r['peak_mem_gb']} GB")
        print(f"device engine against float64 numpy: {errors}")
        res["device_engine"] = dict(calls=engine, errors=errors)
        del cols

        # ------------------ the per-rank ring and TP over the group (P = 1)
        b_, t, h = FULL["batch"], FULL["seq"], FULL["n_heads"]
        d = FULL["d_model"] // h
        g = torch.Generator(device=dev).manual_seed(4)
        q, k, v = (torch.randn(b_, t, h, d, generator=g, device=dev)
                   for _ in range(3))
        group = gmesh.station_group
        ref = ring_attention_sharded(q, k, v, 1, causal=True)
        out = ring_per_rank(q, k, v, group, causal=True)
        err = (out - ref).abs().max().item()
        lim = F32_TOL + F32_TOL * ref.abs().max().item()
        check(err <= lim, f"per-rank ring off ring_attention_sharded: {err}")
        ring = dict(shape=[b_, t, h, d], max_abs_err=err, tol=lim)
        if dev.type == "cuda":
            ring["ms"] = cuda_ms(lambda: ring_per_rank(q, k, v, group,
                                                       causal=True), 3, 1)
            ring["sharded_ms"] = cuda_ms(lambda: ring_attention_sharded(
                q, k, v, 1, causal=True), 3, 1)
        del q, k, v, ref, out
        dm = FULL["d_model"]
        xm = torch.randn(b_, t, dm, generator=g, device=dev)
        w_up = 0.02 * torch.randn(dm, 4 * dm, generator=g, device=dev)
        w_down = 0.02 * torch.randn(4 * dm, dm, generator=g, device=dev)

        def dense():
            return torch.nn.functional.gelu(xm @ w_up,
                                            approximate="tanh") @ w_down

        want = dense()
        got = tp_mlp(xm, w_up, w_down, group=group)
        err = (got - want).abs().max().item()
        lim = TP_TOL + TP_TOL * want.abs().max().item()
        check(err <= lim, f"tp_mlp over the group off the dense MLP: {err}")
        tp = dict(shape=[b_, t, dm, 4 * dm], max_abs_err=err, tol=lim)
        if dev.type == "cuda":
            tp["ms"] = cuda_ms(lambda: tp_mlp(xm, w_up, w_down, group=group),
                               3, 1)
            tp["dense_ms"] = cuda_ms(dense, 3, 1)
        del xm, w_up, w_down, want, got
        res["ring"], res["tp_mlp"] = ring, tp
        print(f"per-rank ring_attention [{b_},{t},{h},{d}] f32 causal at "
              f"P = 1 vs ring_attention_sharded: {ring}")
        print(f"tp_mlp over the {backend} group at P = 1 vs dense: {tp}")
    finally:
        D.shutdown()
        for key in env:
            os.environ.pop(key, None)
    check(not D.is_initialized(), "the process group outlived phase 13")

    # two gloo ranks on the one card (gloo takes CUDA tensors for the
    # collectives these tasks use; NCCL cannot put two ranks on one card)
    outs, wall = _gloo_two_ranks(dev)
    stations = [_engine_station(r) for r in range(2)]
    errors = _engine_checks(stations, outs[0]["stats"],
                            {m: outs[0][m] for m in AGG_MODES})
    check(all(o["backend"] == "gloo" for o in outs)
          and [o["stats"]["process_index"] for o in outs] == [0, 1]
          and outs[0]["stats"] == {**outs[1]["stats"], "process_index": 0}
          and all(outs[0][m]["weights"] == outs[1][m]["weights"]
                  and outs[0][m]["bias"] == outs[1][m]["bias"]
                  for m in AGG_MODES),
          "the two gloo ranks disagree")
    res["gloo_two_ranks"] = dict(wall_s=wall, errors=errors,
                                 stats=outs[0]["stats"])
    print(f"device engine over two gloo ranks on {dev}: {errors}; "
          f"{wall:.1f} s for both processes")
    launches = dict(fa.flash_forward_cuda.variant_launches)
    check(sum(launches.values()) == 0,
          f"phase 13 launched a flash kernel: {launches}")
    res["launches"] = launches
    return res


# ------------------------------------------------------------------ phase 14
OPS = dict(
    # (a) the reference benchmark's straggler arm (bench.py:2692-2770)
    stations=8, rows=128, rounds=6, quorum=7, over_select=1,
    trials=3,        # rounds/s: the median of 3 timed runs of 6 rounds
    clean_rounds=8,  # clean rounds after the fault, to clear the alert
    work_s=0.005,    # the autopilot arm's local work a station
    # (b) its closed loop (bench.py:2771-2850)
    loop_stations=8, loop_rows=32, loop_features=16, loop_seeded=5,
    loop_rounds=6, loop_local_steps=2, loop_batch=16, loop_lr=0.02,
    loop_key=3, wd_interval=0.4,
    # (c) the closed loop on phase 6's flagship; (e) the fleet push
    flagship_rounds=5, fleet_rounds=3,
    # (f) RSA identities
    payload_bytes=1 << 20, crypto_turns=3,
)
AP_RESILIENCE_PCT = 80.0  # the reference's bar (bench.py:194)
AGG_PARITY = 0.02         # the async aggregate within 2% of the clean one
# (c): the contrarian station's labels go through this fixed permutation
CONTRARIAN_PERM = (5, 6, 7, 8, 9, 0, 1, 2, 3, 4)


def _wait_for(pred, timeout: float, step: float = 0.01) -> float:
    """Seconds until ``pred()`` held (or ``timeout`` passed)."""
    t0 = time.monotonic()
    while not pred() and time.monotonic() - t0 < timeout:
        time.sleep(step)
    return time.monotonic() - t0


def optional_packages() -> dict:
    """Whether ``requests`` and ``cryptography`` import here."""
    import importlib

    found = {}
    for name in ("requests", "cryptography"):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def _ops_straggler(torch, dev):
    """(a) The reference's straggler arm on the port's Federation: clean
    sync rounds, sync rounds with a ``FAULTS`` delay on station 0, and
    ``run_buffered`` (quorum 7, over-select 1) outrunning it; then a
    Federation with ``autopilot: {enabled: true}`` whose watchdog alert
    shrinks station 0's selection weight and restores it on clear."""
    import gc

    from vantage6_tpu_torch.algorithm.decorators import data
    from vantage6_tpu_torch.common.enums import TaskStatus
    from vantage6_tpu_torch.common.faults import FAULTS
    from vantage6_tpu_torch.core.config import FederationConfig
    from vantage6_tpu_torch.fed.fedavg import AsyncRoundSpec
    from vantage6_tpu_torch.runtime.federation import (
        Federation,
        federation_from_datasets,
    )
    from vantage6_tpu_torch.runtime.watchdog import WATCHDOG

    c = OPS
    n_s, rounds = c["stations"], c["rounds"]
    failed = []

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    @data(1)
    def local_mean(df):
        return {"sum": float(df["x"].sum()), "n": int(len(df["x"]))}

    rng = np.random.default_rng(5)
    frames = [{"x": rng.normal(10.0, 1.0, c["rows"])} for _ in range(n_s)]
    fed = federation_from_datasets(
        frames, {"bench-ap": {"local_mean": local_mean}},
        executor_workers=n_s, device=dev)

    def mean_of(runs):
        rs = [r.result for r in runs]
        return sum(r["sum"] for r in rs) / max(sum(r["n"] for r in rs), 1)

    def sync_round():
        t = fed.create_task("bench-ap", {"method": "local_mean"})
        return mean_of([r for r in t.runs
                        if r.status == TaskStatus.COMPLETED])

    def timed(one_round):
        """rounds/s of each arm: the median of ``trials`` timed runs of
        ``rounds`` rounds, after one untimed round; the values of all."""
        one_round()
        runs, vals = [], []
        for _ in range(c["trials"]):
            t0 = time.perf_counter()
            vals += [one_round() for _ in range(rounds)]
            runs.append(rounds / (time.perf_counter() - t0))
        return float(np.median(runs)), runs, vals

    FAULTS.clear()
    # the arms take milliseconds: time them with the collector off, as
    # timeit does (a full collection of this process's heap takes longer)
    gc.collect()
    gc.disable()
    rps_clean, clean_runs, vals_clean = timed(sync_round)
    # the "10x-slow station": ~9 extra clean-round times, clamped
    delay_s = min(1.0, max(0.2, 9.0 / rps_clean))
    FAULTS.configure(f"delay:station=0,seconds={delay_s:.3f}")
    n_slow = max(2, rounds // 3)
    t0 = time.perf_counter()
    for _ in range(n_slow):
        sync_round()
    rps_slow = n_slow / (time.perf_counter() - t0)
    spec = AsyncRoundSpec(quorum=c["quorum"], over_select=c["over_select"],
                          staleness_discount=0.5,
                          deadline_s=max(5.0, 4.0 * delay_s))
    killed, max_stale = 0, 0.0

    def async_round():
        nonlocal killed, max_stale
        r = fed.run_buffered("bench-ap", {"method": "local_mean"}, spec,
                             rng=np.random.default_rng(0))
        killed += len(r["killed"])
        max_stale = max(max_stale, float(max(r["staleness"])))
        accepted = set(r["accepted"])
        return mean_of([x for x in r["task"].runs
                        if x.station_index in accepted])

    rps_async, async_runs, vals_async = timed(async_round)
    gc.enable()
    fault_snapshot = FAULTS.snapshot()
    FAULTS.clear()
    staleness = fed.station_staleness()
    fed.close()
    resilience = 100.0 * rps_async / rps_clean
    mean_clean, mean_async = float(np.mean(vals_clean)), float(
        np.mean(vals_async))
    agg_rel_err = abs(mean_async - mean_clean) / max(abs(mean_clean), 1e-9)
    res = dict(stations=n_s, rounds=rounds, trials=c["trials"],
               delay_s=delay_s, clean_rounds_per_s=rps_clean,
               clean_runs=clean_runs, sync_straggler_rounds_per_s=rps_slow,
               async_rounds_per_s=rps_async, async_runs=async_runs,
               resilience_pct=resilience, stragglers_killed=killed,
               max_staleness=max_stale,
               staleness_after=staleness, aggregate_rel_err=agg_rel_err,
               fault_snapshot=fault_snapshot)
    print(f"ops straggler: clean {rps_clean:.2f} rounds/s, sync with a "
          f"{delay_s:.3f} s straggler {rps_slow:.2f}, run_buffered "
          f"{rps_async:.2f} (resilience {resilience:.1f}% vs "
          f"{AP_RESILIENCE_PCT:g}; runs {clean_runs} and {async_runs}), "
          f"{killed} stragglers killed, aggregate "
          f"rel err {agg_rel_err:.2e} (limit {AGG_PARITY})")
    gate(resilience >= AP_RESILIENCE_PCT,
         f"straggler resilience {resilience:.1f}% < {AP_RESILIENCE_PCT}")
    gate(rps_slow <= 0.5 * rps_clean, "sync rounds did not crater under "
         "the straggler")
    gate(agg_rel_err < AGG_PARITY, "the async aggregate is off the clean "
         "one")

    # the autopilot arm: the Federation is its own actuator
    @data(1)
    def timed_mean(df):
        time.sleep(c["work_s"])  # a station's local work
        return {"sum": float(df["x"].sum()), "n": int(len(df["x"]))}

    cfg = FederationConfig.from_dict({
        "federation": {"name": "ops-autopilot", "executor_workers": n_s,
                       "autopilot": {"enabled": True}},
        "stations": [{"name": f"station_{i}"} for i in range(n_s)],
    })
    afed = Federation(cfg, device=dev,
                      algorithms={"bench-ap": {"timed_mean": timed_mean}})
    afed.set_datasets("default", frames)
    gate(afed.autopilot is not None and afed.autopilot.actuator is afed,
         "the Federation is not its autopilot's actuator")
    try:
        FAULTS.configure(f"delay:station=0,seconds={delay_s:.3f}")
        for _ in range(int(WATCHDOG.config["straggler_rounds"])):
            afed.create_task("bench-ap", {"method": "timed_mean"})
        FAULTS.clear()
        t0 = time.perf_counter()
        WATCHDOG.evaluate()
        eval_ms = 1e3 * (time.perf_counter() - t0)
        named = sorted(a["labels"].get("station") for a in
                       WATCHDOG.active_alerts()
                       if a["rule"] == "straggler_station")
        applied = afed.selection_weights()
        for _ in range(c["clean_rounds"]):
            afed.create_task("bench-ap", {"method": "timed_mean"})
        WATCHDOG.evaluate()
        after = sorted(a["labels"].get("station") for a in
                       WATCHDOG.active_alerts()
                       if a["rule"] == "straggler_station")
        restored = afed.selection_weights()
        digest = afed.autopilot.digest()
    finally:
        FAULTS.clear()
        afed.close()
        WATCHDOG.evaluate()  # the closed federation's alerts clear
    res["autopilot"] = dict(alert_stations=named, weights_applied=applied,
                            alert_stations_after=after,
                            weights_restored=restored, eval_ms=eval_ms,
                            digest=digest)
    print(f"ops straggler autopilot: straggler_station names {named} "
          f"(evaluate {eval_ms:.3f} ms), selection weights {applied}; after "
          f"{c['clean_rounds']} clean rounds alerts {after}, weights "
          f"{restored}")
    gate(0 in named, "straggler_station did not name station 0")
    gate(applied[0] == 0.25, "station 0's selection weight did not drop to "
         "0.25")
    gate(0 not in after and restored[0] == 1.0,
         "station 0's weight was not restored on clear")
    check(not failed, "ops straggler gates failed: " + "; ".join(failed))
    return res


def _ops_closed_loop(torch, dev):
    """(b) The reference's closed loop at its own size on the card."""
    from vantage6_tpu_torch.common.faults import FAULTS
    from vantage6_tpu_torch.common.flight import FLIGHT, read_bundle
    from vantage6_tpu_torch.core.mesh import FederationMesh
    from vantage6_tpu_torch.fed.fedavg import FedAvg, FedAvgSpec
    from vantage6_tpu_torch.runtime.autopilot import ArrayActuator, Autopilot
    from vantage6_tpu_torch.runtime.learning import LEARNING
    from vantage6_tpu_torch.runtime.tracing import TRACER
    from vantage6_tpu_torch.runtime.watchdog import WATCHDOG

    c = OPS
    n_s, n, d, bad, k = (c["loop_stations"], c["loop_rows"],
                         c["loop_features"], c["loop_seeded"],
                         c["loop_rounds"])
    interval = c["wd_interval"]
    failed = []

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    TRACER.configure(enabled=True, sample=1.0)
    WATCHDOG.configure(interval=interval)
    LEARNING.clear()
    FLIGHT.clear()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n_s, n, d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    y_clean = (x @ beta + 0.05 * rng.standard_normal((n_s, n))).astype(
        np.float32)
    xs = torch.from_numpy(x).to(dev)
    ys_clean = torch.from_numpy(y_clean).to(dev)
    # the poisoning goes through the fault harness, on the card
    FAULTS.configure(f"flip:station={bad},fraction=1.0")
    ys = ys_clean.clone()
    flipped = FAULTS.poison_labels(ys[bad], bad)
    FAULTS.clear()
    gate(flipped.device == ys.device and not torch.equal(flipped, ys[bad]),
         "poison_labels did not flip the station's targets on the card")
    ys[bad] = flipped

    def loss_fn(p, bx, by, w):
        return torch.sum(w * (bx @ p - by) ** 2) / torch.clamp_min(
            torch.sum(w), 1.0)

    eng = FedAvg(FederationMesh(n_s, device=dev), FedAvgSpec(
        loss_fn=loss_fn, local_steps=c["loop_local_steps"],
        batch_size=c["loop_batch"], local_lr=c["loop_lr"]))
    counts = torch.full((n_s,), float(n), device=dev)
    p0 = torch.zeros(d, device=dev)
    key = c["loop_key"]
    _, _, losses_bad, stats = eng.run_rounds(p0, xs, ys, counts, key, k)
    _, _, losses_clean, _ = eng.run_rounds(p0, xs, ys_clean, counts, key, k)
    actuator = ArrayActuator(n_s)
    pilot = Autopilot(actuator=actuator,
                      listener_key="chip-smoke-autopilot").attach()
    WATCHDOG.start()
    try:
        with TRACER.span("chip_smoke.autopilot", kind="bench"):
            LEARNING.history("chip-smoke-autopilot").record_engine(
                losses_bad, stats)
        detect_s = _wait_for(lambda: actuator.masked[bad],
                             4 * interval + 2.0)
        masked = np.flatnonzero(actuator.masked).tolist()
        # the engine notes an action just after actuating it
        _wait_for(lambda: pilot.digest()["applied"] >= 1, 1.0)
        mid = read_bundle(FLIGHT.dump(
            os.path.join(HERE, "chiprun_out", "ops_loop_masked.jsonl"),
            reason="chip_smoke"))
        _, _, losses_masked, _ = eng.run_rounds(
            p0, xs, ys, counts, key, k, mask=actuator.participation_mask())
        LEARNING.clear()
        revert_s = _wait_for(lambda: not actuator.masked.any(),
                             4 * interval + 2.0)
        reverted = not actuator.masked.any()
        _wait_for(lambda: pilot.digest()["reverted"] >= 1, 1.0)
        digest = pilot.digest()
        post = read_bundle(FLIGHT.dump(
            os.path.join(HERE, "chiprun_out", "ops_loop.jsonl"),
            reason="chip_smoke"))
    finally:
        pilot.detach()
        WATCHDOG.stop()
    bad_loss, masked_loss, clean_loss = (
        float(losses_bad[-1]), float(losses_masked[-1]),
        float(losses_clean[-1]))
    budget = 2 * interval + 0.5
    alerts = [r for r in mid if r["type"] == "alert"
              and r.get("rule") == "anomalous_station"]
    notes = [r.get("kind") for r in post if r["type"] == "note"]
    res = dict(masked=masked, detect_s=detect_s, budget_s=budget,
               revert_s=revert_s, reverted=reverted,
               poisoned_loss=bad_loss, masked_loss=masked_loss,
               clean_loss=clean_loss, digest=digest,
               alert_records=len(alerts),
               autopilot_notes=[n for n in notes
                                if n and n.startswith("autopilot_")])
    print(f"ops closed loop ({n_s} x {n} x {d}): station {bad} masked "
          f"{detect_s:.3f} s after the record (budget {budget:g} s), masked "
          f"{masked}; final loss poisoned {bad_loss:.5f}, masked "
          f"{masked_loss:.5f}, clean {clean_loss:.5f}; reverted "
          f"{revert_s:.3f} s after clear; dump: {len(alerts)} alert "
          f"records, notes {res['autopilot_notes']}")
    gate(masked == [bad] and detect_s <= budget,
         f"station {bad} not auto-masked (alone) within {budget:g} s")
    gate(masked_loss < bad_loss
         and masked_loss <= max(1.5 * clean_loss, clean_loss + 0.05),
         "the masked run did not recover")
    gate(reverted, "the mask did not revert on clear")
    gate(any(a.get("labels", {}).get("station") == bad for a in alerts),
         "the dump taken while masked holds no alert record")
    gate("autopilot_action" in notes and "autopilot_revert" in notes,
         "the dump lacks the autopilot_action/autopilot_revert notes")
    check(not failed, "ops closed-loop gates failed: " + "; ".join(failed))
    return res


def _ops_flagship_loop(torch, dev):
    """(c) The closed loop on phase 6's flagship at full width, cuDNN
    deterministic: one station's labels permuted (``CONTRARIAN_PERM``),
    the engine's history feeding the watchdog, an ``ArrayActuator(32)``
    masking the station hands-off, a fused run under its mask."""
    from vantage6_tpu_torch._tree import tree_leaves
    from vantage6_tpu_torch.runtime.autopilot import ArrayActuator, Autopilot
    from vantage6_tpu_torch.runtime.learning import LEARNING
    from vantage6_tpu_torch.runtime.watchdog import WATCHDOG
    from vantage6_tpu_torch.utils.datasets import synthetic_image_classes
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    cfg, c = FEDAVG, OPS
    n_s, k, interval = cfg["stations"], c["flagship_rounds"], c["wd_interval"]
    sync = torch.cuda.synchronize
    history_key = "chip-smoke-flagship"
    failed = []

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eng = W.make_engine(n_stations=n_s, device=dev,
                            local_steps=cfg["local_steps"],
                            batch_size=cfg["batch"], local_lr=cfg["lr"])
        sx, sy, counts = W.make_federated_data(
            n_s, n_per_station=cfg["per_station"], alpha=cfg["alpha"],
            seed=0, mesh=eng.mesh, noise=cfg["noise"])
        bad = int(torch.argmax(counts))
        perm = torch.tensor(CONTRARIAN_PERM, device=dev)
        sy_bad = sy.clone()
        sy_bad[bad] = perm[sy[bad].long()].to(sy.dtype)
        params0 = W.init_params(1, device=dev)
        ex, ey = synthetic_image_classes(FEDAVG_EVAL["n"],
                                         seed=FEDAVG_EVAL["seed"],
                                         noise=FEDAVG_EVAL["noise"])
        key = 2

        def run(y, mask=None):
            sync()
            t0 = time.perf_counter()
            out = eng.run_rounds(params0, sx, y, counts, key, k, mask=mask)
            sync()
            return 1e3 * (time.perf_counter() - t0) / k, out

        LEARNING.clear()
        actuator = ArrayActuator(n_s)
        pilot = Autopilot(actuator=actuator,
                          listener_key="chip-smoke-flagship").attach()
        torch.cuda.reset_peak_memory_stats()
        WATCHDOG.start(interval=interval)
        try:
            eng.attach_history(history_key)
            first_ms, (p_bad, _, losses_bad, stats) = run(sy_bad)
            eng.attach_history(None)
            capture = eng.last_capture
            detect_s = _wait_for(lambda: actuator.masked[bad],
                                 4 * interval + 2.0)
            named = sorted(int(a["labels"]["station"])
                           for a in WATCHDOG.active_alerts()
                           if a["rule"] == "anomalous_station"
                           and a["labels"].get("task") == history_key)
            masked = np.flatnonzero(actuator.masked).tolist()
            mask = actuator.participation_mask()
            bad_ms, (p_again, *_) = run(sy_bad)
            masked_ms, (p_masked, _, losses_masked, _) = run(sy_bad, mask)
            hand = torch.ones(n_s, device=dev)
            hand[bad] = 0.0
            _, (p_hand, *_) = run(sy_bad, hand)
            _, (p_clean, *_) = run(sy)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            LEARNING.clear()
            revert_s = _wait_for(lambda: not actuator.masked.any(),
                                 4 * interval + 2.0)
            reverted = not actuator.masked.any()
            digest = pilot.digest()
        finally:
            pilot.detach()
            WATCHDOG.stop()
            eng.attach_history(None)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    acc_bad, acc_masked, acc_clean = (W.evaluate(p, ex, ey)
                                      for p in (p_bad, p_masked, p_clean))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a), tree_leaves(b), strict=True))

    cos = stats["station_cos"].float().cpu()
    norm = stats["station_norm"].float().cpu()
    med = norm.median(dim=1).values
    honest = [s for s in range(n_s) if s != bad]
    res = dict(
        station=bad, corruption=f"labels -> CONTRARIAN_PERM[label] = "
        f"{list(CONTRARIAN_PERM)}", count=float(counts[bad]),
        alert_stations=named, masked=masked, detect_s=detect_s,
        revert_s=revert_s, reverted=reverted, digest=digest,
        first_run_ms_per_round=first_ms, poisoned_ms_per_round=bad_ms,
        masked_ms_per_round=masked_ms, peak_mem_gb=peak_gb,
        accuracy=dict(poisoned=acc_bad, masked=acc_masked, clean=acc_clean),
        final_loss=dict(poisoned=float(losses_bad[-1]),
                        masked=float(losses_masked[-1])),
        station_cos=cos[:, bad].tolist(),
        station_norm_over_median=(norm[:, bad] / med).tolist(),
        honest_min_cos=cos[:, honest].min(dim=1).values.tolist(),
        honest_max_norm_over_median=(norm[:, honest].max(dim=1).values
                                     / med).tolist(),
        new_capture=eng.last_capture is not capture,
        repeatable=same(p_again, p_bad), hand_mask_bitwise=same(p_masked,
                                                                 p_hand))
    ratio = [round(v, 2) for v in res["station_norm_over_median"]]
    print(f"ops flagship loop: station {bad} ({res['count']:.0f} rows) "
          f"permuted; cos {[round(v, 3) for v in res['station_cos']]}, "
          f"norm/median {ratio}; honest min cos "
          f"{[round(v, 3) for v in res['honest_min_cos']]}")
    print(f"ops flagship loop: alert names {named}, masked {masked} "
          f"{detect_s:.3f} s after the record; fused {bad_ms:.3f} ms/round "
          f"poisoned, {masked_ms:.3f} masked (first run {first_ms:.3f} "
          f"with the capture), peak {peak_gb:.3f} GB; accuracy poisoned "
          f"{acc_bad:.4f}, masked {acc_masked:.4f}, clean {acc_clean:.4f}; "
          f"hand mask bit for bit {res['hand_mask_bitwise']}; reverted "
          f"{revert_s:.3f} s after clear")
    gate(named == [bad], f"the alert names {named}, not [{bad}]")
    gate(masked == [bad], f"the actuator masked {masked}, not [{bad}]")
    gate(acc_masked > acc_bad, "the masked run is no more accurate than the "
         "poisoned run")
    gate(res["hand_mask_bitwise"], "the autopilot's mask and the same mask "
         "by hand give different params")
    gate(res["repeatable"], "two poisoned runs differ under deterministic "
         "cuDNN")
    gate(not res["new_capture"], "masking a station captured a new graph")
    gate(reverted, "the mask did not revert on clear")
    check(not failed, "ops flagship gates failed: " + "; ".join(failed))
    return res


def _ops_fleet(torch, dev):
    """(e) A phase-10-shaped Federation pushing its fleet snapshot over HTTP
    to a port ``ServerApp``'s ``/api/telemetry`` through
    ``central_fedavg``; after each push ``/api/fleet`` reads the source
    back. The push interval is set to 0, so that every round boundary
    pushes. Returns the Federation, open, for (d)."""
    from vantage6_tpu_torch.client import UserClient
    from vantage6_tpu_torch.common import fleet
    from vantage6_tpu_torch.core.config import FederationConfig
    from vantage6_tpu_torch.runtime import profiling  # noqa: F401 (series)
    from vantage6_tpu_torch.runtime.federation import Federation
    from vantage6_tpu_torch.server.app import ServerApp
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    cfg, k = FEDAVG, OPS["fleet_rounds"]
    n_s = cfg["stations"]
    source = "federation:chip-smoke"
    failed = []

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    fed_cfg = FederationConfig.from_dict({
        "federation": {"name": "fleet-flagship", "executor_workers": 0},
        "stations": [{"name": f"station_{i}", "organization": f"org_{i}",
                      "databases": [{"label": "default", "type": "array"}]}
                     for i in range(n_s)],
    })
    sx, sy, counts = W.make_federated_data(
        n_s, n_per_station=cfg["per_station"], alpha=cfg["alpha"], seed=0,
        noise=cfg["noise"])
    sx, sy, counts = (t.to(dev) for t in (sx, sy, counts))
    fed = Federation(fed_cfg, device=dev, algorithms={"fedavg": W})
    fed.set_datasets("default", [
        {"x": sx[i], "y": sy[i], "count": counts[i],
         "sid": torch.tensor(i, dtype=torch.int32, device=dev)}
        for i in range(n_s)])
    built, pushed = [], []
    build_snapshot = fleet.build_snapshot

    def recording_build(*args, **kw):
        t0 = time.perf_counter()
        snap = build_snapshot(*args, **kw)
        built.append((t0, snap))
        return snap

    srv = ServerApp()
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    client = UserClient(http.url)
    client.authenticate("root", "rootpass123")

    def request(method, endpoint, json_body=None, **kw):
        answer = client.request(method, endpoint, json_body, **kw)
        t1 = time.perf_counter()
        view = client.request("GET", "fleet")
        mine = [r for r in view["sources"] if r["source"] == source]
        pushed.append((t1, method, endpoint, json_body, answer,
                       mine[0] if mine else None))
        return answer

    fleet.build_snapshot = recording_build
    try:
        pusher = fed.attach_fleet_push(request, source=source)
        pusher.interval = 0.0
        task = fed.create_task("fedavg", {
            "method": "central_fedavg",
            "kwargs": dict(n_rounds=k, local_steps=cfg["local_steps"],
                           batch_size=cfg["batch"], lr=cfg["lr"], seed=0)},
            organizations=[0])
        (out,) = fed.wait_for_results(task.id)
        torch.cuda.synchronize()
    finally:
        fleet.build_snapshot = build_snapshot
        http.stop()
        srv.close()
    decoded = [fleet.decode_push(p[3]) for p in pushed]
    ms = [1e3 * (p[0] - b[0]) for p, b in zip(pushed, built)]
    device_series = [sorted(n for n in d["metrics"]
                            if n.startswith("v6t_device_")) for d in decoded]
    names: set = set()
    read_back = []
    for d, p in zip(decoded, pushed):
        names |= set(d["metrics"])
        row = p[5]
        read_back.append(row is not None and row["seq"] == d["seq"]
                         and row["series"] == len(names)
                         and p[4]["accepted"]
                         and p[4]["metrics"] == len(d["metrics"]))
    res = dict(rounds=k, boundaries=k + 1, pushes=len(pushed),
               seqs=[d["seq"] for d in decoded], ms_per_push=ms,
               device_series=device_series[0] if device_series else [],
               metrics_per_push=[len(d["metrics"]) for d in decoded],
               notes_per_push=[len(d["notes"]) for d in decoded],
               read_back=read_back, losses=out["losses"])
    print(f"ops fleet: {len(pushed)} pushes to /api/telemetry over HTTP "
          f"over {k} central_fedavg rounds ({k + 1} round boundaries), seqs "
          f"{res['seqs']}, {res['metrics_per_push']} series, ms per push "
          f"(snapshot to answer) {[round(m, 3) for m in ms]}; read back "
          f"from /api/fleet {read_back}; device series "
          f"{res['device_series']}")
    gate(len(pushed) == k + 1 and len(built) == k + 1,
         f"{len(pushed)} pushes for {k + 1} round boundaries")
    gate(all(p[1] == "post" and p[2] == "telemetry" for p in pushed),
         "a push did not POST to telemetry")
    gate(all(d == b[1] for d, b in zip(decoded, built)),
         "a decoded push differs from its build_snapshot")
    gate(all(read_back), f"/api/fleet did not read a push back: {read_back}")
    gate(all("v6t_device_mem_bytes_in_use" in s for s in device_series),
         "a push lacks the device observatory's series")
    if failed:
        fed.close()
    check(not failed, "ops fleet gates failed: " + "; ".join(failed))
    return fed, res


def _ops_watchdog(fed):
    """(d) One ``WATCHDOG.evaluate()`` over the feeds registered now: the
    learning plane's, the device observatory's and ``fed``'s."""
    from vantage6_tpu_torch.common.telemetry import REGISTRY
    from vantage6_tpu_torch.runtime.watchdog import WATCHDOG

    feeds = ["learning", "device_plane", fed._watchdog_key]
    missing = [f for f in feeds if not WATCHDOG.has_feed(f)]
    check(not missing, f"watchdog feeds not registered: {missing}")
    before = REGISTRY.snapshot().get("v6t_watchdog_feed_errors_total", 0.0)
    t0 = time.perf_counter()
    active = WATCHDOG.evaluate()
    ms = 1e3 * (time.perf_counter() - t0)
    after = REGISTRY.snapshot().get("v6t_watchdog_feed_errors_total", 0.0)
    health = WATCHDOG.health()
    res = dict(feeds=feeds, evaluate_ms=ms, feed_errors=after - before,
               active=[(a["rule"], a["labels"]) for a in active],
               health=health["status"], components=health["components"])
    print(f"ops watchdog: evaluate() over {feeds} {ms:.3f} ms, feed errors "
          f"{after - before:g}, active {res['active']}, health "
          f"{health['status']}")
    check(after == before, f"watchdog feeds failed: {after - before:g} "
          "errors")
    return res


def _ops_identities(dev):
    """(f) RSA identities, where ``cryptography`` imports: a run's
    ``identity()`` signs an advert that ``org_identities()`` verifies, and
    a 1 MB payload crosses as an RSA-sealed v2 frame."""
    if not optional_packages()["cryptography"]:
        out = {"identities": "not run: cryptography is not installed"}
        print(json.dumps(out))
        return out
    from vantage6_tpu_torch.algorithm.context import current_environment
    from vantage6_tpu_torch.algorithm.decorators import data
    from vantage6_tpu_torch.common.encryption import ENC_MAGIC, RSACryptor
    from vantage6_tpu_torch.runtime.federation import federation_from_datasets

    c = OPS

    @data(1)
    def advert(df):
        env = current_environment()
        me, registry = env.identity(), env.org_identities()
        i = env.metadata.node_id
        msg = f"advert of station {i}".encode()
        sig = me.sign_bytes(msg)
        return {"own": RSACryptor.verify_signature(registry[i], msg, sig),
                "other": RSACryptor.verify_signature(registry[1 - i], msg,
                                                     sig)}

    t0 = time.perf_counter()
    RSACryptor.create_new_rsa_key()
    keygen_ms = 1e3 * (time.perf_counter() - t0)
    fed = federation_from_datasets([{"x": np.zeros(1)}] * 2,
                                   {"ids": {"advert": advert}},
                                   executor_workers=0, device=dev)
    try:
        t0 = time.perf_counter()
        task = fed.create_task("ids", {"method": "advert"})
        verdicts = fed.wait_for_results(task.id)
        task_ms = 1e3 * (time.perf_counter() - t0)
        a, b = fed._station_identity(0), fed._station_identity(1)
    finally:
        fed.close()
    payload = np.random.default_rng(0).integers(
        0, 256, c["payload_bytes"], dtype=np.uint8).tobytes()
    enc_ms, dec_ms, ok = [], [], True
    for _ in range(c["crypto_turns"]):
        t0 = time.perf_counter()
        frame = a.encrypt_bytes(payload, b.public_key_str)
        t1 = time.perf_counter()
        back = b.decrypt_bytes(frame)
        enc_ms.append(1e3 * (t1 - t0))
        dec_ms.append(1e3 * (time.perf_counter() - t1))
        ok &= back == payload and frame[:len(ENC_MAGIC)] == ENC_MAGIC
    res = dict(verdicts=verdicts, keygen_ms=keygen_ms,
               signing_task_ms=task_ms, payload_bytes=len(payload),
               encrypt_ms=sorted(enc_ms)[len(enc_ms) // 2],
               decrypt_ms=sorted(dec_ms)[len(dec_ms) // 2], round_trip=ok)
    print(f"ops identities: {RSACryptor.KEY_BITS}-bit keygen "
          f"{keygen_ms:.1f} ms, signing task (2 keygens, sign, verify) "
          f"{task_ms:.1f} ms, verdicts {verdicts}; 1 MB v2 frame encrypt "
          f"{res['encrypt_ms']:.3f} ms, decrypt {res['decrypt_ms']:.3f} ms, "
          f"round trip {ok}")
    check(all(v == {"own": True, "other": False} for v in verdicts),
          f"advert verification failed: {verdicts}")
    check(ok, "the RSA-sealed v2 frame did not round-trip")
    return res


def phase_ops(fa, torch, dev):
    """Phase 14 (module doc): the ops plane around FedAvg on the card."""
    import gc

    from vantage6_tpu_torch.common.faults import FAULTS
    from vantage6_tpu_torch.runtime.learning import LEARNING

    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    # federations that earlier phases left open are collected, so their
    # watchdog feeds drop out; the learning plane starts empty
    gc.collect()
    LEARNING.clear()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    res = {}
    try:
        res["straggler"] = _ops_straggler(torch, dev)
        res["closed_loop"] = _ops_closed_loop(torch, dev)
        res["flagship_loop"] = _ops_flagship_loop(torch, dev)
        fed, res["fleet"] = _ops_fleet(torch, dev)
        try:
            res["watchdog"] = _ops_watchdog(fed)
        finally:
            fed.close()
        res["identities"] = _ops_identities(dev)
    finally:
        FAULTS.clear()
    torch.cuda.synchronize()
    launches = dict(fa.flash_forward_cuda.variant_launches)
    res["launches"] = launches
    print(f"ops flash launches: {launches} (0 expected: host planes, the "
          f"linear loop and the CNN)")
    check(sum(launches.values()) == 0,
          f"phase 14 launched a flash kernel: {launches}")
    return res


CRYPTO = dict(mask_scale=2.0**16, paillier_bits=2048,
              km_grid=list(range(52, 521, 52)), drop_station=7,
              upload_timeout=30.0, workers=8, rate_encryptions=16,
              preprocess_rows=4096, seed=15)
SECURE_AVG_ATOL = 1e-3  # the reference tests' tolerance for the averages
KM_SURV_ATOL = 1e-12    # the Paillier KM against the float64 plain KM


def _flagship_deltas(torch, dev):
    """One flagship FedAvg-CNN round's station deltas, flattened to
    ``[32, 421642]`` f32 on the card (phase 13's round: phase 6's data,
    ``init_params(1)``, the batch indices of ``Generator(2)``)."""
    from vantage6_tpu_torch.core.mesh import FederationMesh
    from vantage6_tpu_torch.fed.fedavg import local_sgd
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    fcfg = FEDAVG
    mesh = FederationMesh(fcfg["stations"], device=dev)
    eng = W.make_engine(mesh, local_steps=fcfg["local_steps"],
                        batch_size=fcfg["batch"], local_lr=fcfg["lr"])
    sx, sy, counts = W.make_federated_data(
        fcfg["stations"], n_per_station=fcfg["per_station"],
        alpha=fcfg["alpha"], seed=0, mesh=mesh, noise=fcfg["noise"])
    params0 = W.init_params(1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    idx = eng.draw_batch_indices(counts, gen)[0]
    with torch.no_grad():
        deltas, _ = mesh.fed_map(
            lambda x, y, i, p: local_sgd(W.weighted_ce_loss, x, y, i, p,
                                         fcfg["lr"]),
            sx, sy, idx, replicated_args=(params0,), batched=True)
    return torch.cat([d.reshape(fcfg["stations"], -1)
                      for d in _leaves(deltas)], dim=1)


def _crypto_native(torch, dev):
    """(a) The native ChaCha20 masks over one flagship round's deltas."""
    import secrets

    from vantage6_tpu_torch import native
    from vantage6_tpu_torch.fed.collectives import fed_sum

    cache = os.path.join(HERE, "build", "native")
    os.environ["V6T_NATIVE_CACHE"] = cache
    so = os.path.join(cache, native.LIB_NAME)
    existed = os.path.exists(so)
    native.lib.cache_clear()
    t0 = time.perf_counter()
    available = native.native_available()
    build_s = time.perf_counter() - t0
    check(available, "the native secure-aggregation library did not build "
                     "(g++ missing or failing); the smoke allows no numpy "
                     "fallback")
    lib_path = native.lib()._name
    check(os.path.samefile(lib_path, so), f"native library at {lib_path}")
    print(f"crypto native: {'loaded' if existed else 'built'} {lib_path} "
          f"from vantage6_tpu_torch/native/secureagg.cpp in {build_s:.3f} s")

    flat = _flagship_deltas(torch, dev)
    n_s, n_flat = flat.shape
    summed = fed_sum(flat).cpu().numpy()
    host = flat.cpu().numpy()
    del flat
    scale = CRYPTO["mask_scale"]
    peak = float(np.abs(host).max())
    check(n_s * peak * scale < 2.0**31,
          f"deltas up to {peak} overflow int32 at scale {scale}")
    seed = secrets.token_bytes(32)
    tag = secrets.token_hex(16)
    t0 = time.perf_counter()
    uploads = np.stack([native.mask_update(seed, s, n_s, host[s], scale,
                                           tag=tag) for s in range(n_s)])
    mask_ms = 1e3 * (time.perf_counter() - t0) / n_s
    t0 = time.perf_counter()
    total = native.unmask_sum(uploads, scale)
    unmask_ms = 1e3 * (time.perf_counter() - t0)
    err = float(np.abs(total - summed).max())
    tol = n_s * 0.5 / scale
    # one station through the numpy fallback: the same upload, bit for bit
    k = n_s - 1
    os.environ["V6T_DISABLE_NATIVE"] = "1"
    native.lib.cache_clear()
    try:
        check(not native.native_available(), "V6T_DISABLE_NATIVE ignored")
        t0 = time.perf_counter()
        fallback = native.mask_update(seed, k, n_s, host[k], scale, tag=tag)
        fallback_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        del os.environ["V6T_DISABLE_NATIVE"]
        native.lib.cache_clear()
    check(native.native_available(), "native library lost after fallback")
    same = bool(np.array_equal(fallback, uploads[k]))
    masked = float(np.mean(uploads[0] == native.quantize(host[0], scale)))
    res = dict(library=lib_path, built=not existed, build_s=build_s,
               shape=[n_s, n_flat], scale=scale, peak_abs=peak,
               max_abs_err=err, tol=tol, fallback_bit_identical=same,
               plaintext_share_of_upload=masked,
               mask_ms_per_station=mask_ms,
               fallback_ms_per_station=fallback_ms, unmask_ms=unmask_ms)
    print(f"gate crypto native: unmask_sum of {n_s} masked [{n_flat}] "
          f"deltas vs the card's fed_sum max_abs_err {err:.3e} (tol {tol:.3e}"
          f" = {n_s} x 0.5/scale); station {k}'s upload native == numpy "
          f"fallback {same}; mask_update {mask_ms:.3f} ms per station native,"
          f" {fallback_ms:.3f} ms numpy; unmask_sum {unmask_ms:.3f} ms")
    check(err <= tol, f"native masked sum off fed_sum by {err}")
    check(same, "the native upload differs from the numpy fallback")
    check(masked < 0.01, f"upload equals its plaintext at {masked}")
    return res


def _crypto_secure_averages(fed, f0):
    """(b) The seeded, DH and Bonawitz averages through ``fed`` (32
    stations), and Bonawitz with one upload dropped."""
    import secrets

    from vantage6_tpu_torch.common.encryption import RSACryptor
    from vantage6_tpu_torch.common.faults import FAULTS

    res = {}
    n_s = fed.n_stations

    def run(method, **kwargs):
        t0 = time.perf_counter()
        task = fed.create_task("sa", {"method": method, "kwargs": dict(
            column="f0", **kwargs)}, organizations=[0])
        (out,) = fed.wait_for_results(task.id)
        return out, 1e3 * (time.perf_counter() - t0)

    def gate(name, out, ms, keep, dropped=()):
        pooled = np.concatenate([f0[i] for i in keep])
        err = abs(out["average"] - float(pooled.mean()))
        exact = out["count"] == pooled.size
        res[name] = dict(average=out["average"], count=out["count"],
                         ref_average=float(pooled.mean()), abs_err=err,
                         tol=SECURE_AVG_ATOL, count_exact=exact, ms=ms,
                         dropped=out.get("dropped"))
        print(f"gate crypto {name}: count {out['count']} == {pooled.size} "
              f"{exact}; average {out['average']:.9f} vs float64 "
              f"{float(pooled.mean()):.9f} abs_err {err:.3e} (tol "
              f"{SECURE_AVG_ATOL}); dropped {out.get('dropped')}; "
              f"{ms:.1f} ms")
        check(exact, f"{name} count {out['count']} != {pooled.size}")
        check(err <= SECURE_AVG_ATOL, f"{name} average off by {err}")
        if "dropped" in out:
            check(out["dropped"] == sorted(dropped),
                  f"{name} dropped {out['dropped']}, expected {dropped}")

    everyone = list(range(n_s))
    out, ms = run("central_secure_average", seed_hex=secrets.token_hex(32))
    gate("seeded", out, ms, everyone)
    # the 32 RSA identity keygens, apart from the DH run
    t0 = time.perf_counter()
    registry = fed._org_identity_registry()
    keygen_ms = 1e3 * (time.perf_counter() - t0)
    check(len(registry) == n_s, "identity registry incomplete")
    res["identity_keygens"] = dict(n=n_s, bits=RSACryptor.KEY_BITS,
                                   ms=keygen_ms)
    print(f"crypto identities: {n_s} {RSACryptor.KEY_BITS}-bit RSA keygens "
          f"{keygen_ms:.1f} ms")
    first = max(fed.tasks) + 1
    out, ms = run("central_secure_average_dh")
    adverts = [r.result for t in fed.tasks.values() if t.id >= first
               and t.method == "partial_advertise_mask_key" for r in t.runs]
    signed = len(adverts) == n_s and all(a.get("signature")
                                         for a in adverts)
    print(f"gate crypto dh: {len(adverts)} adverts, all signed {signed}")
    check(signed, "DH adverts unsigned")
    gate("dh", out, ms, everyone)
    out, ms = run("central_secure_average_bonawitz",
                  upload_timeout=CRYPTO["upload_timeout"],
                  poll_interval=0.01)
    gate("bonawitz", out, ms, everyone)
    k = CRYPTO["drop_station"]
    # station k's runs: advertise, share, then the upload, which is dropped
    FAULTS.configure(f"drop:station={k},after=2,limit=1")
    try:
        out, ms = run("central_secure_average_bonawitz",
                      upload_timeout=CRYPTO["upload_timeout"],
                      poll_interval=0.01)
    finally:
        FAULTS.clear()
    gate("bonawitz_dropout", out, ms, [s for s in everyone if s != k], [k])
    return res


def _crypto_paillier_km(fed, time_, event):
    """(c) Rung 5: Kaplan-Meier under Paillier across the 32 stations."""
    from vantage6_tpu_torch.common import paillier
    from vantage6_tpu_torch.workloads import survival as SV

    grid = [float(g) for g in CRYPTO["km_grid"]]
    t0 = time.perf_counter()
    pk, sk = paillier.keygen(bits=CRYPTO["paillier_bits"])
    keygen_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for m in range(CRYPTO["rate_encryptions"]):
        pk.encrypt(m)
    enc_per_s = CRYPTO["rate_encryptions"] / (time.perf_counter() - t0)
    n_enc = 2 * len(grid) * fed.n_stations
    t0 = time.perf_counter()
    task = fed.create_task("survival", {
        "method": "central_kaplan_meier_paillier",
        "kwargs": {"time_col": "time", "event_col": "event", "grid": grid,
                   "public_key_n": hex(pk.n)}}, organizations=[0])
    (out,) = fed.wait_for_results(task.id)
    task_ms = 1e3 * (time.perf_counter() - t0)
    cts = out["events_ct"] + out["at_risk_ct"]
    ciphertext = (len(cts) == 2 * len(grid)
                  and all(isinstance(c, str) and c.startswith("0x")
                          and pk.n <= int(c, 16) < pk.n_sq for c in cts))
    t0 = time.perf_counter()
    km = SV.decrypt_km(sk, out)
    decrypt_ms = 1e3 * (time.perf_counter() - t0)
    # the plain KM on the same grid: the plain partials through the task
    # plane, and the pooled float64 numpy counts
    task = fed.create_task("survival", {
        "method": "partial_km_counts",
        "kwargs": {"time_col": "time", "event_col": "event",
                   "grid": grid}})
    parts = fed.wait_for_results(task.id)
    events = np.sum([r["events"] for r in parts], axis=0)
    at_risk = np.sum([r["at_risk"] for r in parts], axis=0)
    pt, pe = np.concatenate(time_), np.concatenate(event)
    g = np.asarray(grid)
    events_np = ((pt[None, :] == g[:, None]) * pe[None, :]).sum(1)
    at_risk_np = (pt[None, :] >= g[:, None]).sum(1).astype(np.float64)
    surv_ref = np.cumprod(1.0 - events_np / np.maximum(at_risk_np, 1.0))
    exact = (km["events"] == events.tolist() == events_np.tolist()
             and km["at_risk"] == at_risk.tolist() == at_risk_np.tolist())
    err = float(np.abs(np.asarray(km["survival"]) - surv_ref).max())
    res = dict(bits=CRYPTO["paillier_bits"], grid=grid,
               stations=fed.n_stations, encryptions=n_enc, keygen_ms=keygen_ms,
               encryptions_per_s=enc_per_s,
               task_encryptions_per_s=n_enc / (task_ms / 1e3),
               task_ms=task_ms, decrypt_ms=decrypt_ms,
               all_ciphertext=ciphertext, counts_exact=exact,
               survival_max_abs_err=err, survival_tol=KM_SURV_ATOL,
               events=km["events"], at_risk=km["at_risk"],
               survival=km["survival"])
    print(f"gate crypto paillier km: {fed.n_stations} stations, grid "
          f"{len(grid)} (weeks {int(grid[0])}-{int(grid[-1])}), "
          f"{CRYPTO['paillier_bits']}-bit key ({keygen_ms:.1f} ms keygen); "
          f"every aggregate ciphertext {ciphertext}; decrypted counts == "
          f"plain partials' == numpy {exact}; survival vs float64 max_abs_err "
          f"{err:.3e} (tol {KM_SURV_ATOL}); task {task_ms:.1f} ms for "
          f"{n_enc} encryptions ({n_enc / (task_ms / 1e3):.2f}/s), "
          f"{enc_per_s:.2f} encryptions/s alone, decrypt_km "
          f"{decrypt_ms:.1f} ms")
    check(ciphertext, "a Paillier aggregate is not ciphertext")
    check(exact, "Paillier KM counts differ from the plain KM's")
    check(err <= KM_SURV_ATOL, f"Paillier KM survival off by {err}")
    return res


def _crypto_preprocess(dev):
    """(d) ``preprocess`` where pandas imports."""
    import importlib

    try:
        importlib.import_module("pandas")
    except ImportError:
        print("crypto preprocess: pandas is not installed here, so "
              "preprocess was not run")
        return {"run": False, "reason": "pandas is not installed"}
    from vantage6_tpu_torch.runtime.federation import federation_from_datasets
    from vantage6_tpu_torch.workloads import preprocess

    rng = np.random.default_rng(CRYPTO["seed"])
    n = CRYPTO["preprocess_rows"]
    cols = {"age": rng.uniform(18, 90, n),
            "weight_kg": rng.uniform(45, 120, n),
            "height_m": rng.uniform(1.45, 2.0, n)}
    steps = [{"op": "filter", "column": "age", "cmp": "ge", "value": 40},
             {"op": "derive", "column": "bmi",
              "expr": {"op": "div", "args": ["weight_kg", "height_m"]}},
             {"op": "select", "columns": ["age", "bmi"]}]
    fed = federation_from_datasets([cols], {"pre": preprocess}, device=dev,
                                   executor_workers=0)
    try:
        task = fed.create_task("pre", {"method": "preprocess",
                                       "kwargs": {"steps": steps}})
        (out,) = fed.wait_for_results(task.id)
    finally:
        fed.close()
    keep = cols["age"] >= 40
    ok = (list(out.columns) == ["age", "bmi"] and len(out) == keep.sum()
          and np.array_equal(out["bmi"].to_numpy(),
                             cols["weight_kg"][keep] / cols["height_m"][keep]))
    print(f"crypto preprocess: {len(out)} of {n} rows, columns "
          f"{list(out.columns)}, equal to numpy {ok}")
    check(ok, "preprocess result differs from numpy")
    return {"run": True, "rows": int(len(out)), "equal": ok}


def phase_crypto(fa, torch, dev):
    """Phase 15 (module doc): the host crypto and secure aggregation."""
    import gc

    from vantage6_tpu_torch.runtime.federation import federation_from_datasets
    from vantage6_tpu_torch.workloads import secure_average
    from vantage6_tpu_torch.workloads import survival as SV

    check(optional_packages()["cryptography"],
          "phase 15 needs cryptography (X25519, RSA identities)")
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    gc.collect()
    t_phase = time.perf_counter()
    res = {"native": _crypto_native(torch, dev)}
    _, counts, keep, x, time_, event, _ = _registry(WORKLOADS, torch, dev)
    f0 = [x[i, :c, 0].astype(np.float64) for i, c in enumerate(counts)]
    times = [time_[i, :c].astype(np.float64) for i, c in enumerate(counts)]
    events = [event[i, :c].astype(np.float64) for i, c in enumerate(counts)]
    del x, time_, event, keep
    print(f"crypto registry: {len(counts)} stations, {int(counts.sum())} "
          f"patients (ragged up to {WORKLOADS['rows']}), column f0")
    fed = federation_from_datasets(
        [{"f0": a, "time": t, "event": e} for a, t, e in zip(f0, times,
                                                              events)],
        {"sa": secure_average, "survival": SV}, device=dev,
        executor_workers=CRYPTO["workers"])
    try:
        res["secure_average"] = _crypto_secure_averages(fed, f0)
        res["paillier_km"] = _crypto_paillier_km(fed, times, events)
    finally:
        fed.close()
    res["preprocess"] = _crypto_preprocess(dev)
    res["seconds"] = time.perf_counter() - t_phase
    launches = dict(fa.flash_forward_cuda.variant_launches)
    res["launches"] = launches
    print(f"crypto flash launches: {launches} (0 expected: host crypto); "
          f"phase {res['seconds']:.1f} s")
    check(sum(launches.values()) == 0,
          f"phase 15 launched a flash kernel: {launches}")
    return res


# phase 16: the reference's control-plane leg (bench.py:114-116,
# 1127-1288), phase 13's station through the daemon's device engine, and
# phase 12's registry behind 32 daemons
CONTROL = dict(daemons=8, tasks=40, width=2, rows=32, seed=7, turns=3,
               profile_seconds=4.0, fleet_push_interval=0.5,
               sandbox_rows=4096)
FANOUT_FED_RTOL = 1e-14    # REST vs in-process central_average: float64
FANOUT_NUMPY_RTOL = 1e-12  # ... and against numpy's float64 mean
CP_PASSWORD = "rootpass123"


class _ControlStack:
    """A port ``ServerApp`` on a real socket, a root ``UserClient``, and
    the inline daemons added to it (each on its own CSV, in a
    collaboration of its own)."""

    def __init__(self, client_event_push: bool = True):
        from vantage6_tpu_torch.client import UserClient
        from vantage6_tpu_torch.server.app import ServerApp

        self.srv = ServerApp()
        self.srv.ensure_root(password=CP_PASSWORD)
        self.http = self.srv.serve(port=0, background=True)
        self.client = UserClient(self.http.url)
        if not client_event_push:
            self.client._event_push = False  # pin the fixed-interval poll
        self.client.authenticate("root", CP_PASSWORD)
        self.daemons = []
        self.names = []

    def collaboration(self, name, csvs, algorithms, **daemon_kw):
        """Organizations ``{name}{i}``, one per CSV, in one collaboration,
        each with an inline daemon started on its CSV. Returns (collab,
        orgs, daemons)."""
        from vantage6_tpu_torch.node.daemon import NodeDaemon

        c = self.client
        orgs = [c.organization.create(name=f"{name}{i:02d}")
                for i in range(len(csvs))]
        collab = c.collaboration.create(
            name=name, organization_ids=[o["id"] for o in orgs])
        daemons = []
        for org, csv in zip(orgs, csvs):
            key = c.node.create(organization_id=org["id"],
                                collaboration_id=collab["id"])["api_key"]
            kw = dict(mode="inline", poll_interval=0.25)
            kw.update(daemon_kw)
            d = NodeDaemon(api_url=self.http.url, api_key=key,
                           algorithms=algorithms,
                           databases=[{"label": "default", "type": "csv",
                                       "uri": csv}], **kw)
            d.start()
            daemons.append(d)
            self.daemons.append(d)
            self.names.append(d.name)
        return collab, orgs, daemons

    def stop_daemons(self, daemons, fleet_timeout: float = 10.0):
        """Stop ``daemons``, once ``/api/fleet`` lists a push of each (the
        sync worker pushes every ``fleet_push_interval``) or after
        ``fleet_timeout`` s."""
        want = {f"daemon:{d.name}" for d in daemons}
        deadline = time.monotonic() + fleet_timeout
        while time.monotonic() < deadline:
            seen = {s["source"] for s in
                    self.client.request("GET", "fleet")["sources"]}
            if want <= seen:
                break
            time.sleep(0.1)
        for d in daemons:
            d.stop()
            self.daemons.remove(d)

    def close(self):
        self.stop_daemons(list(self.daemons), fleet_timeout=0.0)
        self.http.stop()
        self.srv.close()


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def _cp_leg(tmp):
    """(a) The reference's control-plane leg as it stands, both arms."""
    import pandas as pd

    from vantage6_tpu_torch.common.enums import TaskStatus
    from vantage6_tpu_torch.common.rest import REST_STATS

    cfg = CONTROL
    n_d, n_t, width = cfg["daemons"], cfg["tasks"], cfg["width"]
    rng = np.random.default_rng(cfg["seed"])
    csvs, ages = [], []
    for i in range(n_d):
        path = os.path.join(tmp, f"cp{i:02d}.csv")
        pd.DataFrame({"age": rng.uniform(20, 80, cfg["rows"]).round(1)}
                     ).to_csv(path, index=False)
        csvs.append(path)
        ages.append(pd.read_csv(path)["age"].to_numpy(np.float64))
    algos = {"v6-average-py": "vantage6_tpu_torch.workloads.average"}

    def arm(fast):
        stack = _ControlStack(client_event_push=fast)
        try:
            collab, orgs, _ = stack.collaboration(
                "cp", csvs, algos, transport="batched" if fast else "per-run",
                event_wait=2.0 if fast else 0.0)
            c, org_ids = stack.client, [o["id"] for o in orgs]
            stats0 = REST_STATS.snapshot()
            lat, dispatch, results, parity = [], [], [], True
            t_all = time.perf_counter()
            for i in range(n_t):
                targets = [org_ids[(i + k) % n_d] for k in range(width)]
                t0 = time.perf_counter()
                t = c.task.create(
                    collaboration=collab["id"], organizations=targets,
                    image="v6-average-py",
                    input_={"method": "partial_average",
                            "kwargs": {"column": "age"}})
                res = c.wait_for_results(t["id"], interval=0.25,
                                         timeout=120.0)
                lat.append(time.perf_counter() - t0)
                results.append(res)
                runs = c.run.from_task(t["id"])
                parity &= sorted(r["organization"]["id"] for r in runs) \
                    == sorted(targets)
                parity &= all(TaskStatus(r["status"])
                              == TaskStatus.COMPLETED for r in runs)
                dispatch += [r["started_at"] - r["assigned_at"] for r in runs
                             if r["started_at"] and r["assigned_at"]]
            total_s = time.perf_counter() - t_all
            stats1 = REST_STATS.snapshot()
        finally:
            stack.close()
        calls = stats1["calls"] - stats0["calls"]
        return dict(task_p50_ms=1e3 * float(np.median(lat)),
                    task_p95_ms=1e3 * _pct(lat, 95),
                    dispatch_p50_ms=1e3 * float(np.median(dispatch)),
                    dispatch_p95_ms=1e3 * _pct(dispatch, 95),
                    tasks_per_s=n_t / total_s, rest_calls=int(calls),
                    rest_calls_per_task=calls / n_t,
                    stale_retries=int(stats1["stale_retries"]
                                      - stats0["stale_retries"]),
                    parity_ok=bool(parity)), results

    legacy, legacy_results = arm(fast=False)
    fast, fast_results = arm(fast=True)
    # each task's pooled mean from its partials against numpy's
    worst = 0.0
    for i, res in enumerate(fast_results):
        pooled = np.concatenate([ages[(i + k) % n_d] for k in range(width)])
        got = sum(r["sum"] for r in res) / sum(r["count"] for r in res)
        worst = max(worst, abs(got - pooled.mean()) / abs(pooled.mean()))
        check(sum(r["count"] for r in res) == pooled.size,
              f"control-plane task {i}: count off numpy")
    out = dict(daemons=n_d, tasks=n_t, width=width,
               per_run_polled=legacy, batched_pushed=fast,
               results_identical=legacy_results == fast_results,
               max_rel_err_vs_numpy=worst)
    for name, a in (("per-run + polled", legacy), ("batched + pushed", fast)):
        print(f"control plane {name}: task p50/p95 {a['task_p50_ms']:.1f}/"
              f"{a['task_p95_ms']:.1f} ms, dispatch p50/p95 "
              f"{a['dispatch_p50_ms']:.1f}/{a['dispatch_p95_ms']:.1f} ms, "
              f"{a['tasks_per_s']:.2f} tasks/s, "
              f"{a['rest_calls_per_task']:.1f} REST calls per task, "
              f"{a['stale_retries']} stale retries, parity {a['parity_ok']}")
    print(f"control plane: results identical across the arms "
          f"{out['results_identical']}, worst task mean vs numpy "
          f"{worst:.3e} (rel)")
    check(legacy["parity_ok"] and fast["parity_ok"],
          "a control-plane task lost, duplicated or failed a run")
    check(out["results_identical"], "the two arms' results differ")
    check(worst <= 1e-12, f"a task mean is off numpy's: {worst:.3e}")
    return out


def _cp_device_engine(torch, dev, stack, tmp):
    """(b) Phase 13's station through the daemon's device engine on the
    card: each call against the same call made directly, bit for bit, and
    a profile window over one task holding CUDA kernel events."""
    import threading

    import pandas as pd

    from vantage6_tpu_torch.runtime import profiling
    from vantage6_tpu_torch.workloads import device_engine as DE

    cfg, n = DISTRIBUTED, DISTRIBUTED["rows"]
    cols, features = _engine_station(0)
    csv = os.path.join(tmp, "engine_station.csv")
    pd.DataFrame(cols).to_csv(csv, index=False)
    df = pd.read_csv(csv)  # what the daemon loads for each run
    collab, orgs, (daemon,) = stack.collaboration(
        "engine", [csv],
        {"device-engine": "vantage6_tpu_torch.workloads.device_engine"},
        # the daemon's default device, the card; the CPU only where this
        # phase is rehearsed on it
        device_engine={} if dev.type == "cuda" else {"device": "cpu"},
        poll_interval=0.05,
        fleet_push_interval=CONTROL["fleet_push_interval"])
    check(daemon.engine_device.type == dev.type
          and daemon.runner.engine_device == daemon.engine_device,
          f"the device-engine daemon runs on {daemon.engine_device}")
    c = stack.client
    calls = {"device_column_stats": dict(column="age", pad_to=n)}
    for mode in AGG_MODES:
        calls[f"device_logistic_fit_{mode}"] = dict(
            feature_columns=features, label_column="label",
            rounds=cfg["rounds"], local_steps=cfg["local_steps"],
            batch_rows=n, lr=cfg["lr"], agg_mode=mode)

    def rest(method, kwargs):
        t = c.task.create(collaboration=collab["id"],
                          organizations=[orgs[0]["id"]],
                          image="device-engine", engine="device",
                          input_={"method": method, "kwargs": kwargs})
        (out,) = c.wait_for_results(t["id"], interval=0.01, timeout=300)
        return out

    def direct(method, kwargs):
        out = getattr(DE, method).__wrapped__(df, device=dev, **kwargs)
        torch.cuda.synchronize()
        return out

    res = {}
    for name, kwargs in calls.items():
        method = name if name == "device_column_stats" \
            else "device_logistic_fit"
        rest_ms, direct_ms, same = [], [], True
        direct(method, kwargs)  # warm-up
        for _ in range(CONTROL["turns"]):
            t0 = time.perf_counter()
            a = rest(method, kwargs)
            rest_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            b = direct(method, kwargs)
            direct_ms.append(1e3 * (time.perf_counter() - t0))
            same &= a == b
        res[name] = dict(rest_ms=float(np.median(rest_ms)),
                         direct_ms=float(np.median(direct_ms)),
                         rest_runs_ms=rest_ms, direct_runs_ms=direct_ms,
                         bit_identical=bool(same))
        print(f"device engine via REST {name}: submit->result "
              f"{res[name]['rest_ms']:.1f} ms, direct call "
              f"{res[name]['direct_ms']:.3f} ms (medians of "
              f"{CONTROL['turns']}, in turns), bit for bit {same}")
        check(same, f"{name} through REST differs from the direct call")

    # a profile window taken through the server around one task
    window = {}

    def profile():
        window.update(c.util.debug_profile(
            seconds=CONTROL["profile_seconds"]))

    th = threading.Thread(target=profile)
    th.start()
    t0 = time.monotonic()
    while not profiling._PROFILE_LOCK.locked() \
            and time.monotonic() - t0 < 10:
        time.sleep(0.01)
    time.sleep(0.5)
    t0 = time.perf_counter()
    rest("device_logistic_fit", calls["device_logistic_fit_replicated"])
    task_s = time.perf_counter() - t0
    th.join()
    kernels = profiling.trace_kernel_events(window["trace"])
    res["profile"] = dict(seconds=window["seconds"], task_s=task_s,
                          kernel_events=kernels, trace=window["trace"])
    print(f"device engine via REST: a {window['seconds']} s "
          f"/api/debug/profile window around one task ({task_s:.3f} s) "
          f"holds {kernels} CUDA kernel events")
    check(task_s + 0.5 < CONTROL["profile_seconds"],
          "the task outlasted the profile window")
    check(kernels > 0, "the profile window holds no CUDA kernel")
    stack.stop_daemons([daemon])
    return res


def _cp_fanout(torch, dev, stack, tmp):
    """(c) ``central_average`` over phase 12's registry behind 32 inline
    daemons (researcher -> node A -> proxy -> 32 subtasks), against the
    in-process Federation and numpy."""
    import pandas as pd

    from vantage6_tpu_torch.runtime.federation import federation_from_datasets
    from vantage6_tpu_torch.workloads import average

    _, counts, _, x, *_ = _registry(WORKLOADS, torch, dev)
    f0 = [x[i, :c, 0].astype(np.float64) for i, c in enumerate(counts)]
    del x
    csvs = []
    for i, a in enumerate(f0):
        path = os.path.join(tmp, f"registry{i:02d}.csv")
        pd.DataFrame({"f0": a}).to_csv(path, index=False)
        csvs.append(path)
    t0 = time.perf_counter()
    collab, orgs, daemons = stack.collaboration(
        "registry", csvs,
        {"v6-average-py": "vantage6_tpu_torch.workloads.average"},
        poll_interval=0.05,
        fleet_push_interval=CONTROL["fleet_push_interval"])
    start_s = time.perf_counter() - t0
    c = stack.client
    t0 = time.perf_counter()
    task = c.task.create(collaboration=collab["id"],
                         organizations=[orgs[0]["id"]],
                         image="v6-average-py",
                         input_={"method": "central_average",
                                 "kwargs": {"column": "f0"}})
    (rest_out,) = c.wait_for_results(task["id"], interval=0.01, timeout=300)
    rest_ms = 1e3 * (time.perf_counter() - t0)
    subtasks = [t for t in c.task.list()
                if (t.get("parent") or {}).get("id") == task["id"]]
    stack.stop_daemons(daemons)

    fed = federation_from_datasets(
        [pd.DataFrame({"f0": a}) for a in f0], {"avg": average},
        device=dev, executor_workers=WORKLOADS["workers"])
    try:
        t0 = time.perf_counter()
        t = fed.create_task("avg", {"method": "central_average",
                                    "kwargs": {"column": "f0"}},
                            organizations=[0])
        (fed_out,) = fed.wait_for_results(t.id)
        fed_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        fed.close()
    pooled = np.concatenate(f0)
    rel_fed = abs(rest_out["average"] - fed_out["average"]) \
        / abs(fed_out["average"])
    rel_np = abs(rest_out["average"] - pooled.mean()) / abs(pooled.mean())
    res = dict(stations=len(f0), patients=int(counts.sum()),
               daemons_start_s=start_s, rest_ms=rest_ms, federation_ms=fed_ms,
               rest=rest_out, federation=fed_out, numpy=float(pooled.mean()),
               rel_err_vs_federation=rel_fed, rel_err_vs_numpy=rel_np,
               subtasks=len(subtasks))
    print(f"central fan-out: {len(f0)} daemons ({start_s:.1f} s to start) "
          f"over {res['patients']} patients: REST {rest_ms:.1f} ms, "
          f"in-process Federation {fed_ms:.1f} ms; average "
          f"{rest_out['average']!r} vs Federation {fed_out['average']!r} "
          f"(rel {rel_fed:.3e}), numpy {pooled.mean()!r} (rel "
          f"{rel_np:.3e}); {len(subtasks)} subtask(s)")
    check(rest_out["count"] == fed_out["count"] == pooled.size,
          f"fan-out counts {rest_out['count']}, {fed_out['count']} != "
          f"{pooled.size}")
    check(rel_fed <= FANOUT_FED_RTOL,
          f"REST average off the Federation's: {rel_fed:.3e}")
    check(rel_np <= FANOUT_NUMPY_RTOL,
          f"REST average off numpy's: {rel_np:.3e}")
    return res


def _cp_sandbox(stack, tmp):
    """(d) One sandboxed ``partial_average``: a child process that runs
    the port's ``wrap_algorithm`` with the card hidden; ``jax`` shadowed
    by a package that records any import of it."""
    import pandas as pd

    shadow = os.path.join(tmp, "shadow")
    os.makedirs(os.path.join(shadow, "jax"), exist_ok=True)
    marker = os.path.join(tmp, "jax_imported")
    with open(os.path.join(shadow, "jax", "__init__.py"), "w") as f:
        f.write(f"open({marker!r}, 'w').close()\n"
                "raise ImportError('jax is blocked in the sandbox')\n")
    rng = np.random.default_rng(CONTROL["seed"])
    path = os.path.join(tmp, "sandbox.csv")
    pd.DataFrame({"age": rng.uniform(20, 80, CONTROL["sandbox_rows"])
                  .round(1)}).to_csv(path, index=False)
    age = pd.read_csv(path)["age"]
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = shadow
    try:
        collab, orgs, (daemon,) = stack.collaboration(
            "sandbox", [path],
            {"v6-average-py": "vantage6_tpu_torch.workloads.average"},
            mode="sandbox", poll_interval=0.05,
            fleet_push_interval=CONTROL["fleet_push_interval"])
        c = stack.client
        t0 = time.perf_counter()
        t = c.task.create(collaboration=collab["id"],
                          organizations=[orgs[0]["id"]],
                          image="v6-average-py",
                          input_={"method": "partial_average",
                                  "kwargs": {"column": "age"}})
        (out,) = c.wait_for_results(t["id"], interval=0.01, timeout=300)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        stack.stop_daemons([daemon])
    finally:
        if old is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = old
    res = dict(wall_ms=wall_ms, result=out, jax_imported=os.path.exists(
        marker), rows=int(age.size))
    print(f"sandboxed partial_average: child run {wall_ms:.1f} ms "
          f"(submit->result), {out}, jax imported {res['jax_imported']}")
    check(not res["jax_imported"], "the sandboxed child imported jax")
    check(out["count"] == age.size
          and abs(out["sum"] - float(age.sum())) <= 1e-9 * abs(age.sum()),
          f"sandboxed partial_average off pandas: {out}")
    return res


def _cp_surfaces(stack, daemon_names):
    """(e) The server's own surfaces after (b)-(d): health, metrics and
    the daemons' fleet pushes read back from ``/api/fleet``."""
    c = stack.client
    health = c.util.health()
    text = c.util.metrics()
    names = {line.split("{")[0].split(" ")[0] for line in text.splitlines()
             if line and not line.startswith("#")}
    wanted = ("v6t_http_requests_total", "v6t_event_hub", "v6t_auth_cache",
              "v6t_rest", "v6t_device_")
    present = {w: any(n.startswith(w) for n in names) for w in wanted}
    fleet = c.request("GET", "fleet")
    pushed = {s["source"]: s for s in fleet["sources"]}
    read_back = {n: f"daemon:{n}" in pushed for n in daemon_names}
    res = dict(health=health["status"], components={
        k: v.get("ok") for k, v in health.get("components", {}).items()},
        metrics=present, series=len(names), fleet_sources=sorted(pushed),
        daemons_read_back=read_back)
    print(f"server surfaces: health {health['status']} "
          f"{res['components']}, /api/metrics {len(names)} series "
          f"{present}, /api/fleet sources {sorted(pushed)}")
    check(health["status"] == "ok", f"server health {health['status']}")
    check(all(present.values()), f"/api/metrics lacks series: {present}")
    check(all(read_back.values()),
          f"daemons' fleet pushes not in /api/fleet: {read_back}")
    return res


def phase_control_plane(fa, torch, dev):
    """Phase 16 (module doc): the REST stack on the card."""
    import gc
    import shutil
    import tempfile

    from vantage6_tpu_torch.runtime import profiling  # noqa: F401 (series)

    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    gc.collect()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="v6t-control-plane-")
    try:
        res = {"leg": _cp_leg(tmp)}
        stack = _ControlStack()
        try:
            res["device_engine"] = _cp_device_engine(torch, dev, stack, tmp)
            res["fanout"] = _cp_fanout(torch, dev, stack, tmp)
            res["sandbox"] = _cp_sandbox(stack, tmp)
            res["surfaces"] = _cp_surfaces(stack, stack.names)
        finally:
            stack.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    torch.cuda.synchronize()
    launches = dict(fa.flash_forward_cuda.variant_launches)
    res["launches"] = launches
    print(f"control plane flash launches: {launches} (0 expected: host "
          f"control plane and the device engine's eager programs); phase "
          f"{res['seconds']:.1f} s")
    check(sum(launches.values()) == 0,
          f"phase 16 launched a flash kernel: {launches}")
    return res


def _leaves(tree):
    from vantage6_tpu_torch._tree import tree_leaves

    return tree_leaves(tree)


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
    # the ring path: the default config in bf16 and f32, then 4 shards
    ring, wire_params = {}, None
    for dtype_name, shards in RING_RUNS:
        name = f"{dtype_name}_P{shards}"
        ring[name], eng_state = phase_ring(fa, ft, torch, dtype_name,
                                           shards)
        if "--profile" in argv:
            prof[f"ring_{name}"] = phase_profile(ft, torch, eng_state,
                                                 f"ring {name}")
        if wire_params is None:  # the default config's, in bf16 compute
            wire_params = eng_state[1]
    del eng_state
    parallel_ops = phase_parallel_ops(torch, dev)
    wire = phase_wire(torch, wire_params)
    del wire_params
    task_plane = phase_task_plane(fa, torch, dev,
                                  profile="--profile" in argv)
    planes = phase_planes(fa, torch, dev)
    workloads = phase_workloads(fa, torch, dev, profile="--profile" in argv)
    distributed = phase_distributed(fa, torch, dev)
    print(json.dumps({"optional_packages": optional_packages()}))
    ops = phase_ops(fa, torch, dev)
    crypto = phase_crypto(fa, torch, dev)
    control = phase_control_plane(fa, torch, dev)
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
    for name, r in ring.items():
        print(f"ring {name}: {r['ms_per_round']:.1f} ms/round, "
              f"{r['tokens_per_s']:.0f} tokens/s, peak "
              f"{r['peak_mem_gb']:.2f} GB on {card}")
    print(f"wire v2 round trip of {wire['elements']} params: encode "
          f"{1e3 * wire['encode_s']:.1f} ms, decode "
          f"{1e3 * wire['decode_s']:.3f} ms on {card}")
    tp = task_plane
    print(f"task plane: central_fedavg "
          f"{tp['central_fedavg']['ms_per_round']:.3f} ms/round through "
          f"create_task, engine eager "
          f"{tp['central_fedavg']['eager_ms_per_round']:.3f} ms/round, "
          f"fused (run_fused_rounds) "
          f"{tp['run_fused_rounds']['ms_per_round']:.3f} ms/round, peak "
          f"{tp['central_fedavg']['peak_mem_gb']:.3f} GB (eager "
          f"{tp['central_fedavg']['eager_peak_mem_gb']:.3f} GB); "
          f"central_average_device "
          f"{tp['central_average_device']['ms']:.3f} ms per call; host task "
          f"{tp['host']['0']['ms']:.3f} ms sequential, "
          f"{tp['host'][str(TASK_PLANE['host_workers'])]['ms']:.3f} ms at "
          f"{TASK_PLANE['host_workers']} workers on {card}")
    ce, ln, ob = (planes["compressed_exchange"], planes["learning"],
                  planes["observatory"])
    print(f"planes: compress_update {ce['compress_update_ms']:.3f} ms, "
          f"decompress_update {ce['decompress_update_ms']:.3f} ms per "
          f"station, v2 encode/decode {ce['encode_ms']:.3f}/"
          f"{ce['decode_ms']:.3f} ms for 32 payloads, reduction "
          f"{ce['reduction']:.3f}x; runtime round learning on/off "
          f"{ln['runtime_on_ms']:.3f}/{ln['runtime_off_ms']:.3f} ms, fused "
          f"with/without history {ln['fused_attached_ms']:.3f}/"
          f"{ln['fused_detached_ms']:.3f} ms; capture {ob['capture_ms']} ms "
          f"(warm-up {ob['warmup_ms']} ms), "
          f"{ob['capture_allocated_bytes']} bytes on {card}")
    for name, r in workloads["programs"].items():
        if name != "profile":
            print(f"workload {name}: {r['ms']:.3f} ms per call, peak "
                  f"{r['peak_mem_gb']:.3f} GB on {card}")
    ds, dr = distributed["scattered"], distributed["fedavg_round"]
    print(f"distributed ({distributed['group']['backend']}, 1 rank): "
          f"scattered mean f32 {ds['f32']['nccl_ms']:.4f} ms (one-card "
          f"{ds['f32']['one_card_ms']:.4f}), bf16 comm "
          f"{ds['bf16']['nccl_ms']:.4f} ms (one-card "
          f"{ds['bf16']['one_card_ms']:.4f}); eager round "
          f"{dr['ms']['nccl']:.3f} ms (plain {dr['ms']['plain']:.3f}) on "
          f"{card}")
    for name, r in distributed["device_engine"]["calls"].items():
        print(f"distributed {name}: {r['ms']:.3f} ms per call, peak "
              f"{r['peak_mem_gb']:.3f} GB on {card}")
    st, cl, fl = ops["straggler"], ops["closed_loop"], ops["flagship_loop"]
    print(f"ops: straggler resilience {st['resilience_pct']:.1f}% "
          f"({st['async_rounds_per_s']:.2f} vs {st['clean_rounds_per_s']:.2f} "
          f"rounds/s); closed loop masked in {cl['detect_s']:.3f} s; flagship "
          f"masked in {fl['detect_s']:.3f} s, fused "
          f"{fl['poisoned_ms_per_round']:.3f}/{fl['masked_ms_per_round']:.3f} "
          f"ms/round poisoned/masked, peak {fl['peak_mem_gb']:.3f} GB; "
          f"watchdog evaluate {ops['watchdog']['evaluate_ms']:.3f} ms; fleet "
          f"push {np.median(ops['fleet']['ms_per_push']):.3f} ms on {card}")
    cn, ca, ck = (crypto["native"], crypto["secure_average"],
                  crypto["paillier_km"])
    print(f"crypto: native mask_update {cn['mask_ms_per_station']:.3f} ms per "
          f"station ({cn['fallback_ms_per_station']:.3f} ms numpy), "
          f"unmask_sum {cn['unmask_ms']:.3f} ms over {cn['shape']}; "
          + ", ".join(f"{k} {ca[k]['ms']:.1f} ms" for k in (
              "seeded", "dh", "bonawitz", "bonawitz_dropout"))
          + f" (32 RSA keygens {ca['identity_keygens']['ms']:.1f} ms apart); "
          f"Paillier KM {ck['task_ms']:.1f} ms, "
          f"{ck['encryptions_per_s']:.2f} encryptions/s; phase "
          f"{crypto['seconds']:.1f} s on {card}")
    lp, lf = (control["leg"]["per_run_polled"],
              control["leg"]["batched_pushed"])
    cd, cf = control["device_engine"], control["fanout"]
    print(f"control plane: batched + pushed task p50/p95 "
          f"{lf['task_p50_ms']:.1f}/{lf['task_p95_ms']:.1f} ms, "
          f"{lf['tasks_per_s']:.2f} tasks/s (per-run + polled "
          f"{lp['task_p50_ms']:.1f}/{lp['task_p95_ms']:.1f} ms, "
          f"{lp['tasks_per_s']:.2f} tasks/s); device engine via REST "
          + ", ".join(f"{k} {v['rest_ms']:.1f} ms (direct "
                      f"{v['direct_ms']:.3f})" for k, v in cd.items()
                      if k != "profile")
          + f"; fan-out over {cf['stations']} daemons {cf['rest_ms']:.1f} ms "
          f"(Federation {cf['federation_ms']:.1f}); sandboxed run "
          f"{control['sandbox']['wall_ms']:.1f} ms; phase "
          f"{control['seconds']:.1f} s on {card}")

    # each kernel at the shape and dtype it serves: the tensor-core kernels
    # at the main path's head dim 128, the CUDA-core one in bf16 at head
    # dim 8
    names = {"tensor_core": ("flash_attention_fwd_tc", "bfloat16"),
             "tf32x3": ("flash_attention_fwd_tf32x3", "float32"),
             "cuda_core": ("flash_attention_fwd", "bfloat16_d8")}
    kernels = [dict(
        name=name, variant=variant, route="cuda",
        source="vantage6_tpu_torch/ops/csrc/"
               + _build.SOURCES[fa.KERNELS[variant].library],
        replaces="vantage6_tpu/ops/flash_attention.py:31",
        launches=sum(r["launches"][variant] for r in slice_res.values())
        + sum(r["launches"][variant] for r in ring.values())
        + fedavg["launches"][variant],
        launches_ring=sum(r["launches"][variant] for r in ring.values()),
        launches_fedavg=fedavg["launches"][variant],
        launches_compression=compression["launches"][variant],
        launches_analysis=analysis["launches"][variant],
        launches_task_plane=task_plane["launches"][variant],
        launches_planes=planes["launches"][variant],
        launches_workloads=workloads["launches"][variant],
        launches_distributed=distributed["launches"][variant],
        launches_ops=ops["launches"][variant],
        launches_crypto=crypto["launches"][variant],
        launches_control_plane=control["launches"][variant],
        **{key: times[case][variant][key] for key in (
            "dtype", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
    ) for variant, (name, case) in names.items()]
    result = dict(card=card, kind=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  max_abs_err_cases=max_err_cases, slice=slice_res,
                  ring=ring, parallel_ops=parallel_ops, wire=wire,
                  fedavg=fedavg, compression=compression, analysis=analysis,
                  task_plane=task_plane, planes=planes,
                  workloads=workloads, distributed=distributed, ops=ops,
                  crypto=crypto, control_plane=control, kernels=kernels,
                  times=times, profile=prof,
                  seconds=time.perf_counter() - t_start)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(json.dumps({"slice": slice_res, "ring": ring,
                      "parallel_ops": parallel_ops, "wire": wire,
                      "fedavg": fedavg,
                      "compression": compression, "analysis": analysis,
                      "task_plane": task_plane, "planes": planes,
                      "workloads": workloads, "distributed": distributed,
                      "ops": ops, "crypto": crypto,
                      "control_plane": control}, default=str))
    # the card again, near the end: a long results line above can push the
    # first one out of a truncated capture of the output
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
