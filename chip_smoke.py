#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check its kernels.

    python3 chip_smoke.py            # from the repository root; one card
    python3 chip_smoke.py --profile  # also trace a round of each run

Phases, each of which raises (exit code 1) on failure:

1. build every hand-written kernel from ``vantage6_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, all at once) and print ptxas's register,
   spill and shared-memory report;
2. each kernel against its plain PyTorch version on the card, at the
   kernel's own tiles for the head dim: the tensor-core kernel in bf16 and
   the TF32x3 kernel in f32 at each width they are instantiated for, at
   D = 8, 24, 80 and 96 (run on a wider instantiation's zero-filled
   columns), at D = 12 (zero-padded by the wrapper), and above 256 at
   D = 320 and 512 and at 300 (padded to 304), run in O slabs of at most
   256 over depth chunks, each slab bit-equal to the first where V's
   columns repeat its first 256; the CUDA-core kernel beside them at the
   widths it takes (8-128, powers of two);
   causal and not, Tq and Tk off the tiles, Tq != Tk, ring-hop offsets
   that leave tiles partly visible, keys ahead of queries, a negative
   scale, fully masked rows (exact zeros) at every width; each error
   beside its tolerance;
3. f32 gradients through the autograd wrapper, whose forward is the
   TF32x3 kernel (and whose backward is the plain recompute), against the
   dense reference; then the same shapes in bf16, whose backward is the
   tensor-core backward kernel, against the float64 dense gradients within
   ``BF16_GRAD_TOL``, beside the plain backward's error on the same inputs;
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
   within the dtype's tolerance; (c) the same round at Phi-3-mini's
   published widths (d_model 3072, 32 heads of 96, vocab 32064; the
   repo's transformer, so no rotary embedding and no gated MLP), depth
   cut to 2 layers, 4 stations of 4 x 1024 tokens, bf16, 3 rounds with
   station 3 masked in the last: head dim 96 runs the tensor-core kernel
   on zero-filled columns, which must launch rounds x stations x layers
   times and no other kernel at all, and the loss must equal a
   ``recompute`` round's from the same state within 2^-8; (d) the same at
   a head dim above 256 (``WIDE``: d_model 4096, 8 heads of 512, 2
   layers, 4 stations of 2 x 1024 tokens, bf16, 2 rounds): the
   tensor-core kernel's O slabs over depth chunks, rounds x stations x
   layers launches of it and no other kernel, the loss against a
   ``recompute`` round's within 2^-8;
5. times on the card: ms per round, tokens/s and peak memory of each run,
   and each kernel's ms per launch at [B, 8, 1024, D] causal (``TIMED``):
   at the main path's D = 128 beside the CUDA-core kernel on the same
   tensors, in turns (bf16: tensor-core; f32: TF32x3); bf16 at D = 8, the
   tensor-core kernel beside the CUDA-core one; both dtypes at D = 96,
   at D = 256 (batch 8) and at D = 320 and 512 (batch 4); each with its
   plain version's time, the bound (bytes, tensor-core products or the
   exps on the special-function units, whichever is largest), and
   ``scaled_dot_product_attention`` in the same dtype as a yardstick (the
   port never calls it), with the backend it picks (its flash backend
   stops at head dim 256); then the bf16 backward kernel's ms per launch
   at ``BWD_TIMED``'s shapes (causal: both GPT-2 cells' at D = 64, phase
   4's at 128, phase 4 (c)'s at 96 and the Moonlight cell's at 192), held to the float64 dense
   gradients and to the plain backward on the same inputs within
   ``BF16_GRAD_TOL``, beside the plain backward's time, its bound (the
   Q K^T recompute and the dV, dP, dQ and dK products, 10 D operations a
   visible pair, against q, k, v, o and dO read and dq, dk and dv written
   once) and SDPA's backward as the yardstick (timed only); each is a row
   of the ``kernels`` line;
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
   against the dense MLP at phase 9's shapes, errors and ms; three
   compressed FedAvg rounds (phase 7's compressor, station 1 masked in
   the second) and ``secure_sum`` of ``[32, 421642]`` values on the group
   mesh, each bit for bit the plain mesh's, timed in turns. (f) ROADMAP
   item 12.1: 8 fused flagship rounds on the group mesh (one CUDA graph
   with the NCCL collectives captured in it) bit for bit 8 eager rounds
   on the group and the one-card ``run_rounds``, a traced replay (one
   graph launch, no NCCL call on the host, the device's kernels), ms a
   fused round beside the one-card fused round's. (g) Item 12.4: phase
   4's full width (bf16, flash, FULL's 4 stations) for 2 rounds through
   ``make_engine(..., group=)`` bit for bit the one-card engine, its
   ``tensor_core`` launches, ms a round and peak memory. The group is
   destroyed; then two gloo ranks on the card run the device engine's
   tasks, three compressed rounds of 8 flagship stations (4 a rank, each
   station's local steps on their own) and the same ``secure_sum`` (16
   stations a rank), each bit for bit the one-process form (sha256 of the
   bytes); (f) 4 fused rounds of 8 flagship stations captured in segments
   cut at each collective, bit for bit 4 eager rounds over the same
   group; (g) the transformer rounds over both ranks, 2 stations a rank,
   the losses and params within ``DIST_TRANSFORMER``'s tolerances of the
   one-card run, each rank's ``tensor_core`` launches, ms and peak; (h)
   item 12.5: a ``Federation`` over both ranks (16 of 32 stations a rank)
   runs one device-mode ``central_fedavg`` round of the flagship,
   ``central_average`` and the seeded secure average over 4,096 ages a
   station, every rank's task records equal to the one-process
   Federation's (rank 0 runs it too), each host run executed once, on its
   station's rank, and ms a task of both. Only (g)'s rounds may launch a
   flash kernel.

14. the ops plane around FedAvg, after a line saying whether ``requests``
   and ``cryptography`` import here. (a) The reference benchmark's
   straggler arm (``bench.py:2692-2770``): 8 host stations of 128 rows at
   8 executor workers, clean sync rounds, sync rounds with a ``FAULTS``
   delay on station 0 of ``min(1, max(0.2, 9 x the clean round))`` s, and
   ``run_buffered`` (quorum 7, over-select 1); each arm after one untimed
   round, with the collector off, the two timed in turns (clean, then
   buffered, 7 pairs of runs of 30 rounds, each clean run after an untimed
   sync round that waits out the buffered arm's last straggler), each
   pair's ratio printed;
   its gates: the median of the pairs' ratios at least 80%, sync with the
   straggler at most half the clean median, the aggregate within 2%.
   Then a Federation
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
   behind 32 inline daemons pushing fleet telemetry at the default 15 s:
   ``central_average`` researcher -> node A -> proxy -> 32 runs ->
   aggregate, twice: quiet, before any daemon's first push is due, and
   loaded, with the server's own snapshot and each daemon's push fired
   once, evenly over the first half of the quiet one's length; each
   count exact and each average within 1e-14 of the in-process
   ``Federation``'s and 1e-12 of numpy's; the loaded one ingests at least
   33 pushes between submit and result, leaves health "ok" and every
   daemon read back from ``/api/fleet``. Wall ms of each and of the
   Federation, and each REST wall split into its hops from the runs'
   server stamps (the central's claim, the subtasks' creation, each
   subtask's claim and its run, that is its CSV load and partial, the
   central's wait after the last partial, the researcher's wake-up),
   after the server's own split over the daemons' start and over each
   fan-out: the time its handlers spend in ``health_block``, in
   ``sources`` outside it, in the telemetry push's inserts and prunes,
   and waiting for and holding the database lock, the holds by caller
   (the route or thread that took the lock) and by statement. (d) One
   ``partial_average`` through a sandbox-mode daemon: a
   child process with the card hidden and ``jax`` shadowed by a package
   that records any import; the child's wall ms. (e) ``/api/health`` ok,
   ``/api/metrics`` with the server's series and ``v6t_device_*``, and
   each daemon of (b)-(d) read back from ``/api/fleet`` ((b)'s and (d)'s
   push every 5 s). No flash kernel may launch.

17. the CLI on the card (``click`` and PyYAML required; without either
   one line says it was not run), each command a child process that sees
   the card, with ``jax`` shadowed by a package that records any import
   of it (none may) and the XDG roots in a temporary directory. (a)
   ``v6t-torch run`` of ``central_fedavg`` (5 rounds, seed 0) from a
   federation YAML of phase 6's flagship data, each station an ``array``
   ``.npz`` of ``{"x", "y", "count", "sid"}``: its losses equal bit for
   bit the same call's made in this process (``FederationConfig.load`` ->
   ``Federation`` -> ``create_task``); the command's and the call's
   seconds. (b) ``server new``/``import``/``start`` and ``node new``/
   ``start``, the node's YAML given ``device_engine: {}``, phase 13's
   station as its CSV: ``device_column_stats`` and ``device_logistic_fit``
   in its three ``agg_mode``s through a ``UserClient``, each equal bit for
   bit to the direct call; the node's log names the card; no pid alive
   after ``node stop`` and ``server stop``. (c) ``dev
   create-demo-network -n 3`` and ``start-demo-network`` (ports 7601 and
   7602 must be free): ``central_average`` over ``age`` as ``dev_admin``
   within 1e-12 of numpy over the 3 CSVs, the 8 approved algorithms of the
   demo store through ``/api/store/algorithm``, no pid alive after
   ``stop-demo-network``. (d) ``v6t-torch test`` prints ``smoke OK`` and
   ``algorithm create``'s generated test passes. No flash kernel may
   launch in the processes the commands ran: each child's
   ``sitecustomize`` writes its flash launch counts when it exits (at exit
   or on ``stop``'s SIGTERM), every process the phase started must have
   written them, and their sum is ``launches_cli``.

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
# bf16 gradients against float64: each is a sum over the keys (queries) of
# terms whose factors P and dS the backward kernel rounds to bf16 (2^-9
# relative each), and it is itself rounded to bf16; 4 ulps of 2^-8 of the
# largest gradient
BF16_GRAD_TOL = 4 * 2.0**-8
# the bf16 backward kernel's timed shapes, causal ((case, B, H, T, D)):
# both GPT-2 cells' attention calls at D = 64, phase 4's at W = 128,
# phase 4 (c)'s at D = 96 (W = 128, zero-filled), and the Moonlight cell's
# MLA call at q/k 192 (the W = 192 pair)
BWD_TIMED = (("ctx1024_d64", 8, 16, 1024, 64),
             ("ctx128_d64", 64, 16, 128, 64),
             ("slice_d128", 16, 8, 1024, 128),
             ("phi3_d96", 4, 32, 1024, 96),
             ("moonlight_d192", 8, 16, 2048, 192))
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
# Phi-3-mini's published widths (microsoft/Phi-3-mini-4k-instruct
# config.json: hidden_size 3072, num_attention_heads 32, so head dim 96,
# vocab_size 32064) in the repo's own transformer, which has no rotary
# embedding and no gated MLP (its MLP is 4 x d_model, Phi-3-mini's 8192);
# depth cut from 32 layers to 2, 4 stations of 4 x 1024 tokens
PHI3 = dict(d_model=3072, n_layers=2, n_heads=32, seq=1024, batch=4,
            vocab=32064, stations=4)
PHI3_ROUNDS = 3  # the last one (DROP_ROUND) with station 3 masked out
# a head dim above 256: the repo's transformer at d_model 4096 with 8 heads
# of 512 (the width runs the kernels' O slabs over depth chunks), 2 layers,
# 4 stations of 2 x 1024 tokens, bf16; two rounds
WIDE = dict(d_model=4096, n_layers=2, n_heads=8, seq=1024, batch=2,
            vocab=4096, stations=4)
WIDE_ROUNDS = 2

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


EX2_PER_CLOCK = 16  # ex2 a clock per SM (Hopper's special-function units)


def exp_rate(torch) -> float:
    """ex2 a second of the card: EX2_PER_CLOCK a clock on each SM at the
    card's maximum SM clock (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    mhz = float(out.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EX2_PER_CLOCK * sms * mhz * 1e6


def attention_bound(b, h, t_q, t_k, d, q_offset, k_offset, causal,
                    elem_bytes, peak_flops, ex2_per_s):
    """(bound_ms, bound_by, term): the largest of the bytes q, k, v, o must
    move over the memory rate, the products the unmasked scores need (2*d
    for q.k and 2*d for p.v per visible pair) over the tensor cores' peak,
    and their exps (one per visible score) over the card's ex2 rate.
    ``bound_by`` is "bytes" or "operations"; ``term`` names the winner
    ("bytes", "tensor" or "exp")."""
    if causal:
        vis = sum(min(max(q_offset + i - k_offset + 1, 0), t_k)
                  for i in range(t_q))
    else:
        vis = t_q * t_k
    terms = {
        "bytes": elem_bytes * b * h * d * (2 * t_q + 2 * t_k) / PEAK_BYTES,
        "tensor": 4.0 * d * vis * b * h / peak_flops,
        "exp": vis * b * h / ex2_per_s,
    }
    term = max(terms, key=terms.get)
    return (1e3 * terms[term], "bytes" if term == "bytes" else "operations",
            term)


def compare(fa, torch, out, q, k, v, qo, ko, causal, scale, variant, tol):
    """Max abs error of a kernel's output against its plain version at the
    kernel's tiles for this head dim, checked against
    tol + tol * max|plain|."""
    block_q, block_k = fa.KERNELS[variant].blocks(q.shape[-1])
    plain = fa.kernel_reference(q, k, v, qo, ko, causal, scale, block_q,
                                block_k)
    torch.cuda.synchronize()
    check(out.shape == q.shape and out.dtype == q.dtype, "kernel output shape")
    check(bool(torch.isfinite(out.float()).all()), "non-finite output")
    err = (out.float() - plain.float()).abs().max().item()
    lim = tol + tol * plain.float().abs().max().item()
    check(err <= lim, f"{variant} kernel disagrees with its plain version: "
          f"{err} > {lim}")
    return err, lim


# head dims past the instantiated widths: bf16 at D = 8 (below wgmma's k16
# depth), and widths of real models that run the next instantiation on
# zero-filled columns (Phi-2's 80, Phi-3-mini's 96)
EXTRA_HEAD_DIMS = (8, 24, 80, 96)
PAD_HEAD_DIM = 12  # not a multiple of 8: the wrapper zero-pads q, k and v
# above 256, in O slabs of at most 256 over depth chunks: 320 (a full slab
# and a tail of 64), 512 (two full slabs) and 300 (padded to 304)
WIDE_HEAD_DIMS = (300, 320, 512)


def kernel_widths(fa, variant):
    """The head dims a kernel is held at: its instantiations, and for a
    kernel that pads, the extra widths and the wrapper's pad, and for one
    that runs in slabs, the widths above 256."""
    spec = fa.KERNELS[variant]
    extra = (*EXTRA_HEAD_DIMS, PAD_HEAD_DIM) if spec.pads else ()
    wide = WIDE_HEAD_DIMS if spec.depth else ()
    return sorted(set(spec.head_dims) | set(extra) | set(wide))


def takes(fa, variant, dtype, d):
    spec = fa.KERNELS[variant]
    return dtype in spec.dtypes and spec.width(d) is not None


def phase_kernel_vs_plain(fa, torch, dev):
    """Each kernel against its plain version at the kernel's own tiles."""
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [
        # dtype, causal, B, H, Tq, Tk, D, q_offset, k_offset, scale
        ("f32", False, 2, 4, 96, 96, 64, 0, 0, None),
        ("f32", True, 2, 4, 96, 96, 64, 0, 0, None),
        ("f32", True, 1, 2, 1024, 1024, 128, 0, 0, None),
        ("f32", False, 1, 2, 1024, 1024, 32, 0, 0, None),
        ("f32", True, 2, 2, 100, 228, 16, 128, 0, None),  # ring hop, ragged
        ("f32", True, 1, 3, 256, 512, 8, 256, 0, None),  # ring hop, Tq != Tk
        ("bf16", False, 2, 4, 96, 96, 128, 0, 0, None),
        ("bf16", True, 2, 4, 96, 96, 16, 0, 0, None),
        ("bf16", True, 1, 2, 1024, 1024, 64, 0, 0, None),
        ("bf16", False, 1, 2, 1024, 1024, 128, 0, 0, None),
        ("bf16", True, 2, 2, 100, 228, 32, 128, 0, None),
        ("bf16", True, 1, 3, 256, 512, 8, 256, 0, None),
        # scale 0: every visible p is 1, masked ones still 0
        ("f32", True, 1, 2, 130, 200, 96, 70, 0, 0.0),
        ("bf16", True, 1, 2, 130, 200, 96, 70, 0, 0.0),
    ]
    # the tensor-core (bf16) and TF32x3 (f32) kernels at their edges, each
    # head dim they are instantiated for and the widths they pad to
    for name, variant in (("bf16", "tensor_core"), ("f32", "tf32x3")):
        for d in kernel_widths(fa, variant):
            cases += [
                (name, True, 1, 3, 200, 200, d, 0, 0, None),  # off tiles
                (name, False, 1, 2, 130, 70, d, 0, 0, None),  # Tq != Tk
                (name, True, 2, 2, 150, 333, d, 183, 0, None),  # ring hop
                # keys ahead of queries: rows before 90 fully masked, the
                # rest see a partly visible tile
                (name, True, 1, 2, 257, 100, d, 37, 90, None),
                # a negative scale: the max is of the scaled scores
                (name, True, 1, 2, 130, 200, d, 70, 0, -0.7 * d**-0.5),
            ]
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst = dict.fromkeys(fa.KERNELS, 0.0)
    worst_by_width = {}
    for name, causal, b, h, t_q, t_k, d, qo, ko, scale in cases:
        dt = dtypes[name]
        q = torch.randn(b, h, t_q, d, generator=g, device=dev).to(dt)
        k = torch.randn(b, h, t_k, d, generator=g, device=dev).to(dt)
        v = torch.randn(b, h, t_k, d, generator=g, device=dev).to(dt)
        scale = d**-0.5 if scale is None else scale
        tol = F32_TOL if name == "f32" else BF16_TOL
        # the variant the dispatch picks, and the CUDA-core kernel beside it
        # where it takes the width
        variants = {fa.kernel_variant(dt, d)}
        if takes(fa, "cuda_core", dt, d):
            variants.add("cuda_core")
        for variant in sorted(variants):
            out = fa.flash_forward_cuda(q, k, v, qo, ko, causal, scale,
                                        variant=variant)
            err, lim = compare(fa, torch, out, q, k, v, qo, ko, causal,
                               scale, variant, tol)
            print(f"{variant} vs plain {name} causal={causal} "
                  f"[{b},{h},{t_q}x{t_k},{d}] off=({qo},{ko}) "
                  f"scale={scale:.4g}: max_abs_err {err:.3e} tol {lim:.3e}")
            worst[variant] = max(worst[variant], err)
            key = f"{variant}_d{d}"
            worst_by_width[key] = max(worst_by_width.get(key, 0.0), err)
    # fully masked: every query precedes every key -> exact zeros
    for variant, spec in fa.KERNELS.items():
        for dt in spec.dtypes:
            for d in kernel_widths(fa, variant):
                q = torch.randn(1, 2, 200, d, generator=g, device=dev).to(dt)
                out = fa.flash_forward_cuda(q, q, q, 0, 1000, True, 0.125,
                                            variant=variant)
                torch.cuda.synchronize()
                check(bool((out == 0).all()),
                      f"{variant} at D = {d}: fully masked rows are not "
                      "exact zeros")
    print("kernels fully masked (k_offset=1000), every dtype and head dim "
          "held: exact zeros")
    # above 256 every O slab sees the same S, m and l: with V's columns a
    # repeat of its first 256, the output's slabs are bit-equal
    for variant, spec in fa.KERNELS.items():
        for dt in spec.dtypes if spec.depth else ():
            for d in WIDE_HEAD_DIMS:
                q, k, v0 = (torch.randn(1, 2, 300, w, generator=g,
                                        device=dev).to(dt)
                            for w in (d, d, 256))
                v = torch.cat([v0] * (d // 256 + 1), -1)[..., :d]
                out = fa.flash_forward_cuda(q, k, v.contiguous(), 0, 0,
                                            True, d**-0.5, variant=variant)
                torch.cuda.synchronize()
                for s0 in range(256, d, 256):
                    w = min(256, d - s0)
                    check(torch.equal(out[..., s0:s0 + w], out[..., :w]),
                          f"{variant} at D = {d}: slab {s0 // 256} differs "
                          "from slab 0 on the same V columns")
    print(f"kernels above 256 (D = {WIDE_HEAD_DIMS}): every O slab "
          "bit-equal to the first on repeated V columns")
    return dict(worst, by_width=worst_by_width)


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
        plain_calls = fa.flash_backward_cuda.plain_calls
        grads = torch.autograd.grad(torch.sin(out).sum(), qkv)
        ref = fa.reference(*qkv, q_offset=qo, k_offset=ko, causal=causal)
        ref_grads = torch.autograd.grad(torch.sin(ref).sum(), qkv)
        for name, a, r in zip("qkv", grads, ref_grads):
            err = (a - r).abs().max().item()
            lim = GRAD_TOL + GRAD_TOL * r.abs().max().item()
            print(f"grad d{name} f32 causal={causal} {t_q}x{t_k} "
                  f"off=({qo},{ko}): max_abs_err {err:.3e} tol {lim:.3e}")
            check(err <= lim, f"gradient d{name} disagrees: {err}")
        check(fa.flash_backward_cuda.plain_calls == plain_calls + 1,
              "the f32 backward did not take the plain recompute")
    # the same shapes in bf16: the backward kernel; a loss (out * w).sum()
    # whose output gradient is w, so that float64 sees the same dO
    for t_q, t_k, qo, ko, causal in [(96, 96, 0, 0, True),
                                      (96, 96, 0, 0, False),
                                      (64, 160, 96, 0, True)]:
        qkv = [torch.randn(2, 4, t, 64, generator=g, device=dev)
               .to(torch.bfloat16).requires_grad_() for t in (t_q, t_k, t_k)]
        w = torch.randn(2, 4, t_q, 64, generator=g, device=dev).to(
            torch.bfloat16)
        launches = fa.flash_backward_cuda.launches
        out = fa.flash_attention(*qkv, q_offset=qo, k_offset=ko,
                                 causal=causal)
        grads = torch.autograd.grad((out * w).sum(), qkv)
        check(fa.flash_backward_cuda.launches == launches + 1,
              "the bf16 backward did not launch the backward kernel")
        plain = fa._attention_bwd(*(x.detach() for x in qkv), out.detach(),
                                  w, qo, ko, causal, 64**-0.5)
        x64 = [x.detach().double().requires_grad_() for x in qkv]
        ref = fa.reference(*x64, q_offset=qo, k_offset=ko, causal=causal)
        ref_grads = torch.autograd.grad(ref, x64, w.double())
        for name, a, p, r in zip("qkv", grads, plain, ref_grads):
            err = (a.double() - r).abs().max().item()
            err_plain = (p.double() - r).abs().max().item()
            lim = BF16_GRAD_TOL * r.abs().max().item()
            print(f"grad d{name} bf16 causal={causal} {t_q}x{t_k} "
                  f"off=({qo},{ko}): kernel max_abs_err {err:.3e} (plain "
                  f"{err_plain:.3e}) tol {lim:.3e}")
            check(err <= lim, f"bf16 gradient d{name} disagrees: {err}")


def slice_engine(ft, torch, dtype=None, seq_devices=1, shape=FULL,
                 **cfg_kw):
    """The slice's engine at ``shape``'s widths (default the full width) on
    the card, its tokens and its initial state. ``dtype`` is the compute
    dtype, None for ``TransformerConfig``'s default (f32); ``cfg_kw``
    overrides other config fields (``attention``)."""
    cfg = ft.TransformerConfig(
        vocab=shape["vocab"], d_model=shape["d_model"],
        n_heads=shape["n_heads"], n_layers=shape["n_layers"],
        max_len=shape["seq"], **cfg_kw,
        **({} if dtype is None else {"dtype": dtype}),
    )
    n_s = shape["stations"]
    eng = ft.make_engine(n_stations=n_s, seq_devices=seq_devices, cfg=cfg,
                         lr=1e-3)
    check(eng.device.type == "cuda", "engine is not on the card")
    tokens = eng.shard_tokens(ft.make_federated_tokens(
        n_s, batch=shape["batch"], seq_len=shape["seq"],
        vocab=shape["vocab"],
    ))
    params, opt = eng.init(torch.Generator().manual_seed(0))
    return cfg, eng, tokens, params, opt


def train_rounds(torch, eng, params, opt, tokens, label, rounds=ROUNDS,
                 n_s=FULL["stations"], must_fall=True):
    """``rounds`` rounds from (params, opt), the last station masked out
    in DROP_ROUND; checks that the losses are finite and (``must_fall``)
    fall and the params finite. Returns (params, opt, losses, seconds a
    round, the state the last round started from)."""
    full = torch.ones(n_s)
    drop = torch.tensor([1.0] * (n_s - 1) + [0.0])
    losses, secs = [], []
    for r in range(rounds):
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
    check(not must_fall or losses[-1] < losses[0],
          f"{label}: loss did not fall: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in
              [params["embed"], params["pos"]]
              + [w for layer in params["layers"] for w in layer.values()]),
          f"{label}: non-finite parameters")
    return params, opt, losses, secs, state


def round_figures(torch, secs, shape=FULL):
    """ms/round over the steady rounds (round 0 carries one-time set-up:
    cuBLAS, the kernels' first launch), tokens/s and the peak memory."""
    steady = secs[1:]
    ms = 1e3 * sum(steady) / len(steady)
    tokens_per_round = shape["stations"] * shape["batch"] * shape["seq"]
    return dict(ms_per_round=ms, first_round_ms=1e3 * secs[0],
                round_ms=[1e3 * s for s in secs],
                tokens_per_s=tokens_per_round / (ms / 1e3),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def phase_slice(fa, ft, torch, dev, dtype=None, shape=FULL, rounds=ROUNDS,
                must_fall=True, label=None):
    """The slice at ``shape``'s widths (default the full width) for
    ``rounds`` rounds, flash attention; ``dtype`` is the compute dtype,
    None for ``TransformerConfig``'s default (f32)."""
    cfg, eng, tokens, params, opt = slice_engine(ft, torch, dtype,
                                                 shape=shape,
                                                 attention="flash")
    dtype_name = str(cfg.dtype).removeprefix("torch.")
    label = label or dtype_name
    variant = MAIN_VARIANT[dtype_name]
    check(fa.kernel_variant(cfg.dtype, cfg.head_dim) == variant,
          f"{dtype_name} attention is not served by the {variant} kernel")
    loss_rtol = LOSS_RTOL_F32 if cfg.dtype == torch.float32 else LOSS_RTOL
    n_s = shape["stations"]
    full = torch.ones(n_s)

    # the main path's counts start here
    torch.cuda.reset_peak_memory_stats()
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    fa.flash_backward_cuda.launches = 0
    fa.flash_backward_cuda.plain_calls = 0
    params, opt, losses, secs, state = train_rounds(
        torch, eng, params, opt, tokens, label, rounds=rounds, n_s=n_s,
        must_fall=must_fall)
    launches = dict(fa.flash_forward_cuda.variant_launches)
    backward = dict(kernel=fa.flash_backward_cuda.launches,
                    plain=fa.flash_backward_cuda.plain_calls)
    figures = round_figures(torch, secs, shape)
    expect = rounds * n_s * cfg.n_layers
    print(f"flash kernel launches in the {label} run: {launches} "
          f"(rounds x stations x layers = {expect}); backward {backward}")
    check(launches[variant] == expect,
          f"the {label} run did not run the {variant} kernel")
    check(sum(launches.values()) == expect,
          f"the {label} run ran another kernel than {variant}")
    bwd = fa.backward_variant(dev, cfg.dtype, cfg.head_dim)
    check(backward == (dict(kernel=expect, plain=0) if bwd != "plain"
                       else dict(kernel=0, plain=expect)),
          f"the {label} run's backward is not all {bwd}: {backward}")

    rc_eng = ft.make_engine(
        n_stations=n_s, seq_devices=1,
        cfg=dataclasses.replace(cfg, attention="recompute"), lr=1e-3,
    )
    # the last round's mask: its loss is the mean over those stations
    last_mask = (torch.tensor([1.0] * (n_s - 1) + [0.0])
                 if rounds - 1 == DROP_ROUND else full)
    _, _, rc_loss = rc_eng.round(state[0], state[1], tokens, last_mask)
    rc_loss = rc_loss.item()
    rel = abs(rc_loss - losses[-1]) / abs(rc_loss)
    print(f"{label} loss from the same state: flash {losses[-1]:.6f} "
          f"recompute {rc_loss:.6f} rel diff {rel:.3e} tol {loss_rtol:.3e}")
    check(rel <= loss_rtol, "flash and plain attention rounds disagree")
    check(fa.flash_forward_cuda.launches == expect,
          "the plain round launched a kernel")

    res = dict(
        config=dict(shape, dtype=dtype_name, attention="flash", lr=1e-3),
        head_dim=cfg.head_dim, variant=variant,
        rounds=rounds, losses=losses, **figures,
        launches=launches, launches_per_round=n_s * cfg.n_layers,
        backward_launches=backward, recompute_loss=rc_loss,
        loss_rel_diff=rel, loss_rtol=loss_rtol,
    )
    print(f"{label} slice: {res['ms_per_round']:.1f} ms/round, "
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


# the timed shapes: (case, dtype, batch, head dim, variants in turns); the
# main path's batch, heads and sequence, at D = 256 half the batch (the
# same products as D = 128). D = 8 times the tensor-core kernel beside the
# CUDA-core one it replaced; D = 128 keeps the CUDA-core kernel beside each
# tensor-core kernel, as before. Then every other width phase 2 launches,
# the CUDA-core kernel beside the dispatched one where it takes the width.
TIMED = (
    ("bfloat16", "bfloat16", 16, 128, ("cuda_core", "tensor_core")),
    ("float32", "float32", 16, 128, ("cuda_core", "tf32x3")),
    ("bfloat16_d8", "bfloat16", 16, 8, ("cuda_core", "tensor_core")),
    ("bfloat16_d96", "bfloat16", 16, 96, ("tensor_core",)),
    ("float32_d96", "float32", 16, 96, ("tf32x3",)),
    ("bfloat16_d256", "bfloat16", 8, 256, ("tensor_core",)),
    ("float32_d256", "float32", 8, 256, ("tf32x3",)),
    # above 256, in O slabs over depth chunks, at batch 4
    ("bfloat16_d320", "bfloat16", 4, 320, ("tensor_core",)),
    ("float32_d320", "float32", 4, 320, ("tf32x3",)),
    ("bfloat16_d512", "bfloat16", 4, 512, ("tensor_core",)),
    ("float32_d512", "float32", 4, 512, ("tf32x3",)),
) + tuple(
    (f"{name}_d{d}", name, 16, d,
     (("cuda_core",) if d in (8, 16, 32, 64) else ()) + (variant,))
    for name, variant, widths in (
        ("bfloat16", "tensor_core", (12, 16, 24, 32, 64, 80)),
        ("float32", "tf32x3", (8, 12, 16, 24, 32, 64, 80)))
    for d in widths
)


def sdpa_backend(torch, q, k, v, scale):
    """The backend ``scaled_dot_product_attention`` picks for a causal call
    on these tensors (its flash backend stops at head dim 256)."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, None, 0.0, True, scale=scale)).name


def phase_times(fa, torch, dev):
    """Each kernel at the shapes of TIMED, [B, 8, 1024, D] causal, in the
    dtype it serves, timed in turns with the kernel beside it on the same
    tensors (a, b, b, a; a, a for one), with its plain version's time,
    ``scaled_dot_product_attention``'s in the same dtype as a yardstick
    (the port never calls it) and the bound; then the backward kernel at
    each shape of BWD_TIMED (``backward_figures``). Returns {case: {variant
    or "backward": figures}}."""
    h, t = FULL["n_heads"], FULL["seq"]
    g = torch.Generator(device=dev).manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ex2_per_s = exp_rate(torch)
    res = {}
    for case, name, b, hd, variants in TIMED:
        dtype = getattr(torch, name)
        peak, tol = ((PEAK_TF32_FLOPS, F32_TOL) if dtype == torch.float32
                     else (PEAK_BF16_FLOPS, BF16_TOL))
        scale = hd**-0.5
        shape = f"[{b},{h},{t},{hd}]"
        q, k, v = (torch.randn(b, h, t, hd, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        library_ms = cuda_ms(
            lambda: sdpa(q, k, v, is_causal=True, scale=scale), 20)
        backend = sdpa_backend(torch, q, k, v, scale)
        bound_ms, bound_by, term = attention_bound(
            b, h, t, t, hd, 0, 0, True, q.element_size(), peak, ex2_per_s)
        group = {}
        for variant in variants:
            block_q, block_k = fa.KERNELS[variant].blocks(hd)
            out = fa.flash_forward_cuda(q, k, v, 0, 0, True, scale,
                                        variant=variant)
            err, lim = compare(fa, torch, out, q, k, v, 0, 0, True, scale,
                               variant, tol)
            print(f"{variant} vs plain at {shape} {name} causal: "
                  f"max_abs_err {err:.3e} tol {lim:.3e}")
            plain_ms = cuda_ms(
                lambda: fa.kernel_reference(q, k, v, 0, 0, True, scale,
                                            block_q, block_k),
                3, warmup=1)
            group[variant] = dict(dtype=name, shape=shape, head_dim=hd,
                                  max_abs_err=err, ms=[], plain_ms=plain_ms,
                                  library_ms=library_ms,
                                  library_backend=backend, bound_ms=bound_ms,
                                  bound_by=bound_by, bound_term=term)
            if variant == "tf32x3":
                # the least time of three TF32 passes at the TF32 peak
                group[variant]["tf32x3_floor_ms"] = attention_bound(
                    b, h, t, t, hd, 0, 0, True, 4, peak / TF32_PASSES,
                    ex2_per_s)[0]
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
                  f"{r['plain_ms']:.4f} ms, sdpa {library_ms:.4f} ms "
                  f"({backend}), bound "
                  f"{bound_ms:.4f} ms ({term}){floor}")
        res[case] = group
        del q, k, v, out
    for case, b, h_b, t_b, hd in BWD_TIMED:
        res[case] = {"backward": backward_figures(fa, torch, dev, g, b, h_b,
                                                  t_b, hd)}
    return res


def backward_bound(b, h, t, d, peak_flops):
    """(bound_ms, term) of a causal bf16 attention backward at [b, h, t, d]:
    the Q K^T recompute and the dV, dP, dQ and dK products, 10 d operations
    a visible pair, over the tensor cores' peak, against q, k, v, o and dO
    read and dq, dk and dv written once over the memory rate."""
    pairs = b * h * t * (t + 1) / 2
    terms = {"tensor": 10.0 * d * pairs / peak_flops,
             "bytes": 2.0 * 8 * b * h * t * d / PEAK_BYTES}
    term = max(terms, key=terms.get)
    return 1e3 * terms[term], term


def backward_figures(fa, torch, dev, g, b, h, t, d):
    """The bf16 backward kernel at [b, h, t, d], causal: its gradients held
    to the float64 dense gradients and to the plain backward's on the same
    inputs, ms per launch (CUDA events, two timings in turns with the plain
    backward's one), the bound, and the backward of
    ``scaled_dot_product_attention`` on the same tensors as the yardstick
    (timed only; the port never calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = d**-0.5
    shape = f"[{b},{h},{t},{d}]"
    q, k, v, do = (torch.randn(b, h, t, d, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    o = fa.flash_forward_cuda(q, k, v, 0, 0, True, scale)

    def kernel():
        return fa.flash_backward_cuda(q, k, v, o, do, 0, 0, True, scale)

    def plain():
        return fa._attention_bwd(q, k, v, o, do, 0, 0, True, scale)

    ours, ref = kernel(), plain()
    x64 = [x.double().requires_grad_() for x in (q, k, v)]
    exact = torch.autograd.grad(
        fa.reference(*x64, q_offset=0, k_offset=0, causal=True, scale=scale),
        x64, do.double())
    del x64
    errs, errs_plain, gaps = [], [], []
    for name, a, p, r in zip("qkv", ours, ref, exact):
        errs.append((a.double() - r).abs().max().item())
        errs_plain.append((p.double() - r).abs().max().item())
        gaps.append((a.float() - p.float()).abs().max().item())
        lim = BF16_GRAD_TOL * r.abs().max().item()
        lim_plain = BF16_GRAD_TOL * p.float().abs().max().item()
        print(f"backward d{name} {shape} bf16 causal: kernel max_abs_err "
              f"{errs[-1]:.3e} (plain {errs_plain[-1]:.3e}) tol {lim:.3e}; "
              f"vs plain {gaps[-1]:.3e} tol {lim_plain:.3e}")
        check(errs[-1] <= lim,
              f"backward kernel d{name} vs float64 at {shape}: {errs[-1]}")
        check(gaps[-1] <= lim_plain,
              f"backward kernel d{name} vs plain at {shape}: {gaps[-1]}")
    del exact
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = sdpa(qg, kg, vg, is_causal=True, scale=scale)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), 20)
    backend = sdpa_backend(torch, q, k, v, scale)
    ms = [cuda_ms(kernel, 20)]
    plain_ms = cuda_ms(plain, 3, warmup=1)
    ms.append(cuda_ms(kernel, 20))
    bound_ms, term = backward_bound(b, h, t, d, PEAK_BF16_FLOPS)
    mean = sum(ms) / len(ms)
    print(f"flash_attention_bwd tensor_core {shape} bf16 causal: kernel "
          f"{mean:.4f} ms (runs {ms[0]:.4f}, {ms[1]:.4f}), plain "
          f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms "
          f"({backend}), bound {bound_ms:.4f} ms ({term}), "
          f"{100 * bound_ms / mean:.2f}% of it")
    return dict(dtype="bfloat16", shape=shape, head_dim=d,
                max_abs_err=max(errs), max_abs_err_runs=errs,
                plain_max_abs_err=errs_plain, max_abs_err_vs_plain=gaps,
                ms=mean, ms_runs=ms, plain_ms=plain_ms,
                library_ms=library_ms, library_backend=backend,
                bound_ms=bound_ms,
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term)


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


# phase 13's compressed FedAvg rounds and secure sum across ranks: the
# flagship (phase 6) with phase 7's compressor, three EF-carrying rounds
# from one key, station 1 masked in the second; at NCCL world size one the
# flagship's 32 stations, on the two gloo ranks 8 of its stations (4 a
# rank), each station's local steps on their own (see _looped_mesh). The
# secure sum: 32 stations x the CNN's 421,642 values, N(0, 0.01), station
# 1 masked, at 2^16 quanta a unit.
DIST_COMPRESSED = dict(gloo_stations=8, rounds=3, masked_round=1, masked=1,
                       key=5, secure_key=17, secure_scale=2.0**16,
                       secure_seed=11, secure_values=421642)


def _flagship_data(torch, dev, n_stations):
    """The flagship's data (phase 6's sizes and seed) for ``n_stations``
    stations on ``dev``: (x, y, counts), all stations."""
    from vantage6_tpu_torch.core.mesh import FederationMesh
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    f = FEDAVG
    return W.make_federated_data(
        n_stations, n_per_station=f["per_station"], alpha=f["alpha"],
        seed=0, mesh=FederationMesh(n_stations, device=dev),
        noise=f["noise"])


def _looped_mesh(n_stations, device, group=None):
    """A ``FederationMesh`` whose ``fed_map`` runs each station's function
    on its own instead of under ``vmap``: a batched kernel's bits can
    depend on how many stations it batches, so a layout that puts 4 of 8
    stations on a rank would train them differently from one process
    holding all 8."""
    from vantage6_tpu_torch.core.mesh import FederationMesh

    class Looped(FederationMesh):
        def fed_map(self, fn, *args, replicated_args=(), batched=False):
            return super().fed_map(fn, *args,
                                   replicated_args=replicated_args)

    return Looped(n_stations, device=device, group=group)


def _compressed_rounds(torch, mesh, sx, sy, counts, dev):
    """DIST_COMPRESSED's rounds of the flagship FedAvg with phase 7's
    compressor on ``mesh`` (the data its local block): each round's
    (params, EF, loss, stats)."""
    from vantage6_tpu_torch.fed.compression import CompressorSpec
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    c, f = DIST_COMPRESSED, FEDAVG
    eng = W.make_engine(mesh, local_steps=f["local_steps"],
                        batch_size=f["batch"], local_lr=f["lr"],
                        compressor=CompressorSpec(**COMPRESSOR))
    params = W.init_params(1, device=dev)
    opt = eng.init(params)
    gen = torch.Generator(device=dev).manual_seed(c["key"])
    mask = torch.ones(mesh.n_stations)
    mask[c["masked"]] = 0.0
    out = []
    for r in range(c["rounds"]):
        params, opt, loss, stats = eng.round(
            params, opt, sx, sy, counts, key=gen,
            mask=mask if r == c["masked_round"] else None)
        out.append((params, opt["ef"], loss, stats))
    return out


def _secure_values(torch, dev, rows=None):
    """DIST_COMPRESSED's secure-sum inputs on ``dev``: the ``[32, N]``
    values (``rows`` of them) and the global mask."""
    c = DIST_COMPRESSED
    x = np.random.default_rng(c["secure_seed"]).normal(
        0.0, 0.01, (FEDAVG["stations"], c["secure_values"])).astype(
            np.float32)
    mask = torch.ones(FEDAVG["stations"])
    mask[c["masked"]] = 0.0
    return torch.from_numpy(x if rows is None else x[rows]).to(dev), mask


def _digest(tensors):
    """sha256 of the tensors' bytes, in order: equal digests, equal bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _round_digests(rounds, ef_rows=None):
    """Per round: digests of the params, the EF (its ``ef_rows``), the loss
    and each learning stat."""
    out = []
    for params, ef, loss, stats in rounds:
        out.append(dict(
            params=_digest(_leaves(params)),
            ef=_digest([ef if ef_rows is None else ef[ef_rows]]),
            loss=_digest([loss]),
            **{f"stats.{k}": _digest([v]) for k, v in stats.items()}))
    return out


def _digests_differ(got, want):
    """The (round, field) pairs whose digests differ."""
    return [(r, k) for r, (g, w) in enumerate(zip(got, want))
            for k in sorted(set(g) | set(w)) if g.get(k) != w.get(k)]


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

# phase 13 (f): the fused flagship round across ranks (ROADMAP item 12.1):
# 8 rounds of phase 6's flagship (32 stations) at NCCL world size one, and
# 4 rounds of 8 of its stations (4 a rank) on the two gloo ranks, where the
# round is captured in segments cut at each collective
DIST_FUSED = dict(rounds=8, key=3, gloo_stations=8, gloo_rounds=4)
# phase 13 (g): the transformer engine over ranks (item 12.4) at phase 4's
# full width, bf16, flash attention, 2 rounds of FULL's 4 stations, all on
# the NCCL rank or 2 a gloo rank. Over the gloo ranks the stations'
# gradients are each station's own, bit for bit, and only their sum runs
# in another order (two partial sums all-reduced): the losses within the
# CPU parity tests' rtol, and Adam's params within their lr / 1000
# (tests/test_torch_fed_transformer.py)
DIST_TRANSFORMER = dict(rounds=2, loss_rtol=1e-5, param_atol=1e-3 / 1000)
# phase 13 (h): a Federation over the two gloo ranks (item 12.5), 16 of 32
# stations a rank: one device-mode central_fedavg round of the flagship,
# central_average and the seeded secure average over 4,096 ages a
# station. The device steps run batched, as users run them: a rank vmaps
# its 16 stations where one process vmaps 32, and a batched kernel's bits
# can depend on that count, and the flagship trains in bf16 compute (phase
# 6), where a changed rounding grows over the local steps: on the card a
# station's delta moved by up to 10.5% in norm between one process's
# batched and looped steps, the batching phase 6 holds in its vmap ==
# loop gate. So the device rows and what derives from them (each
# station's delta, loss and count, the central's losses and model move)
# are held no further from the one-process batched rows than twice what
# batching alone moves them in the same run (_federation_spread), the
# host records bit for bit; a second pass runs each station's step on
# its own in both forms (_looped_mesh) and holds every record bit for bit
DIST_FEDERATION = dict(stations=32, rows=4096, seed=21, fedavg_rounds=1,
                       secure_seed="00" * 31 + "2a", spread_factor=2.0)


def _fused_and_eager(torch, eng, params, sx, sy, counts, key, k):
    """``k`` fused rounds and ``k`` eager rounds of one key on ``eng``:
    (fused (params, losses, stats), eager (params, losses, stats))."""
    fused = eng.run_rounds(params, sx, sy, counts, key, k)
    p, o = params, eng.init(params)
    gen = torch.Generator(device=eng.device).manual_seed(key)
    losses, stats = [], []
    for _ in range(k):
        p, o, loss, st = eng.round(p, o, sx, sy, counts, key=gen)
        losses.append(loss)
        stats.append(st)
    eager = (p, torch.stack(losses),
             {n: torch.stack([s[n] for s in stats]) for n in stats[0]})
    return (fused[0], fused[2], fused[3]), eager


def _run_digests(run):
    """Digests of a run's (params, losses, stats)."""
    params, losses, stats = run
    return dict(params=_digest(_leaves(params)), losses=_digest([losses]),
                **{f"stats.{k}": _digest([v]) for k, v in stats.items()})


def _replay_trace(torch, fused):
    """One replay of a captured fused round under the profiler: the host
    events (name -> count) and the device kernels (name -> count)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fused._replay()
        torch.cuda.synchronize()
    host, device = {}, {}
    for ev in prof.key_averages():
        side = (device if ev.device_type == torch.autograd.DeviceType.CUDA
                else host)
        side[ev.key] = side.get(ev.key, 0) + ev.count
    return host, device


def _dist_fused(torch, dev, gmesh, plain, backend, sx, sy, counts):
    """Phase 13 (f) on the group of one rank: the fused flagship rounds
    against eager rounds on the group and the one-card fused run, bit for
    bit; a traced replay; ms a fused round in turns (one card, group,
    group, one card)."""
    from vantage6_tpu_torch.fed.fedavg import capture_form
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    c, f = DIST_FUSED, FEDAVG
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        engines = {m: W.make_engine(m, local_steps=f["local_steps"],
                                    batch_size=f["batch"], local_lr=f["lr"])
                   for m in (plain, gmesh)}
        params0 = W.init_params(1, device=dev)
        group_fused, group_eager = _fused_and_eager(
            torch, engines[gmesh], params0, sx, sy, counts, c["key"],
            c["rounds"])
        one_fused = engines[plain].run_rounds(params0, sx, sy, counts,
                                              c["key"], c["rounds"])
        got = _run_digests(group_fused)
        vs_eager = _digests_differ([got], [_run_digests(group_eager)])
        vs_one = _digests_differ([got], [_run_digests(
            (one_fused[0], one_fused[2], one_fused[3]))])
        check(not vs_eager, f"{c['rounds']} fused rounds on the {backend} "
                            f"group differ from eager rounds at {vs_eager}")
        check(not vs_one, f"the fused rounds on the {backend} group differ "
                          f"from the one-card run_rounds at {vs_one}")
        losses = [float(x) for x in group_fused[1]]
        fused = list(engines[gmesh]._fused.values())[-1]
        form = capture_form(dev, gmesh.group)
        host, device = {}, {}
        if dev.type == "cuda":  # (the phase is rehearsed on the CPU too)
            host, device = _replay_trace(torch, fused)
            nccl_host = {k: v for k, v in host.items()
                         if "nccl" in k.lower() or "c10d" in k.lower()}
            launches = host.get("cudaGraphLaunch", 0)
            check(form == "graph" and fused.graph is not None
                  and launches == 1 and not nccl_host,
                  f"a traced replay is not one graph launch ({form}: host "
                  f"{host})")
        ms = {"one_card": [], backend: []}
        for which in ("one_card", backend, backend, "one_card"):
            eng = engines[plain if which == "one_card" else gmesh]
            ms[which].append(median_ms(
                torch, lambda eng=eng: eng.run_rounds(
                    params0, sx, sy, counts, c["key"], c["rounds"]),
                runs=1, warmup=0, per=c["rounds"])[0])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    res = dict(rounds=c["rounds"], form=form, bit_identical_eager=True,
               bit_identical_one_card=True, losses=losses,
               capture=engines[gmesh].last_capture,
               replay_host_events=host, replay_kernels=device,
               ms_per_round={k: sorted(v)[0] for k, v in ms.items()},
               runs_ms=ms)
    print(f"fused flagship rounds on the {backend} group of 1 rank "
          f"({form} form): {c['rounds']} captured rounds == {c['rounds']} "
          f"eager rounds on the group and == the one-card run_rounds bit for"
          f" bit (params, losses, stats; losses {losses})")
    print(f"a traced replay on the {backend} group: host {host} (no NCCL "
          f"call on the host: the collectives replay inside the graph); "
          f"device kernels {device}")
    print(f"fused round ms on the {backend} group "
          f"{res['ms_per_round'][backend]:.3f} vs one card "
          f"{res['ms_per_round']['one_card']:.3f} (best of 2 turns of "
          f"{c['rounds']} rounds); capture {res['capture']}")
    return res


def _transformer_engine(ft, torch, dev, group=None):
    """Phase 13 (g)'s engine (phase 4's full width, bf16, flash, FULL's 4
    stations) on the card, over ``group`` if given; its tokens (the rank's
    block) and the initial state."""
    shape = FULL
    cfg = ft.TransformerConfig(
        vocab=shape["vocab"], d_model=shape["d_model"],
        n_heads=shape["n_heads"], n_layers=shape["n_layers"],
        max_len=shape["seq"], dtype=torch.bfloat16, attention="flash")
    eng = ft.make_engine(shape["stations"], 1, cfg, lr=1e-3, device=dev,
                         group=group)
    tokens = eng.shard_tokens(ft.make_federated_tokens(
        shape["stations"], batch=shape["batch"], seq_len=shape["seq"],
        vocab=shape["vocab"]))
    params, opt = eng.init(torch.Generator().manual_seed(0))
    return eng, tokens, params, opt


def _transformer_rounds(fa, torch, eng, tokens, params, opt):
    """DIST_TRANSFORMER's rounds from (params, opt): (params, losses, ms a
    round, peak GB, the flash launches of the rounds)."""
    mask = torch.ones(FULL["stations"])
    card = eng.device.type == "cuda"
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.flash_forward_cuda.launches = 0
    fa.flash_forward_cuda.variant_launches = dict.fromkeys(fa.KERNELS, 0)
    fa.flash_backward_cuda.launches = 0
    fa.flash_backward_cuda.plain_calls = 0
    losses, ms = [], []
    for _ in range(DIST_TRANSFORMER["rounds"]):
        t0 = time.perf_counter()
        params, opt, loss = eng.round(params, opt, tokens, mask)
        losses.append(loss.item())
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(fa.flash_forward_cuda.variant_launches)
    return (params, losses, ms,
            torch.cuda.max_memory_allocated() / 1e9 if card else None,
            launches)


def _dist_transformer(fa, ft, torch, dev, group, backend, out_path):
    """Phase 13 (g) on the group of one rank: the full-width bf16 flash
    rounds over the group against the one-card engine, bit for bit; the
    one-card params and losses are written to ``out_path`` for the gloo
    ranks."""
    runs, backward = {}, {}
    for which, grp in (("one_card", None), (backend, group)):
        eng, tokens, params, opt = _transformer_engine(ft, torch, dev, grp)
        runs[which] = _transformer_rounds(fa, torch, eng, tokens, params,
                                          opt)
        backward[which] = (fa.flash_backward_cuda.launches,
                           fa.flash_backward_cuda.plain_calls)
        del eng, tokens, params, opt
    (p1, l1, ms1, peak1, n1), (pg, lg, msg, peakg, ng) = (
        runs["one_card"], runs[backend])
    same = l1 == lg and all(torch.equal(a, b) for a, b in zip(
        _leaves(p1), _leaves(pg), strict=True))
    check(same, f"the transformer rounds on the {backend} group differ from"
                f" the one-card engine's (losses {lg} vs {l1})")
    expect = (DIST_TRANSFORMER["rounds"] * FULL["stations"]
              * FULL["n_layers"] if dev.type == "cuda" else 0)
    check(ng.get("tensor_core", 0) == expect == sum(ng.values()),
          f"the {backend} transformer rounds launched {ng}, not {expect} "
          "tensor_core kernels")
    check(backward[backend] == backward["one_card"] == (expect, 0),
          f"the transformer rounds' backward kernel launches and plain "
          f"calls {backward}, not ({expect}, 0)")
    torch.save({"params": [x.cpu() for x in _leaves(p1)], "losses": l1},
               out_path)
    res = dict(bit_identical=True, losses=lg, round_ms=msg,
               one_card_round_ms=ms1, peak_mem_gb=peakg,
               one_card_peak_mem_gb=peak1, launches=ng,
               one_card_launches=n1)
    print(f"transformer engine (phase 4's width, bf16, flash, "
          f"{FULL['stations']} stations) over the {backend} group of 1 rank"
          f" == the one-card engine bit for bit over "
          f"{DIST_TRANSFORMER['rounds']} rounds (losses {lg}); ms/round "
          f"{[round(x, 1) for x in msg]} vs one card "
          f"{[round(x, 1) for x in ms1]}; peak {peakg} GB vs {peak1} GB; "
          f"launches {ng}")
    return res


def _federation_tables(n_stations):
    """Phase 13 (h)'s ages: one DataFrame of DIST_FEDERATION's rows a
    station, N(50, 10) rounded to 0.1."""
    import pandas as pd

    c = DIST_FEDERATION
    rng = np.random.default_rng(c["seed"])
    return [pd.DataFrame({"age": rng.normal(50.0, 10.0, c["rows"]).round(1)})
            for _ in range(n_stations)]


def _federation_program(torch, fed, images, tables):
    """Phase 13 (h)'s task program on ``fed``: (records, ms a task). A
    record holds a task's name, method, parent (its place), statuses,
    stations, whether it or a subtask has device rows, its runs' results
    and its device rows, as the Federation holds them. Every rank runs
    it, as the one-process form."""
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    c, f = DIST_FEDERATION, FEDAVG
    tasks = (
        ("fedavg", "central_fedavg", dict(
            n_rounds=c["fedavg_rounds"], local_steps=f["local_steps"],
            batch_size=f["batch"], lr=f["lr"], seed=3), images),  # the
        # seed of the init that the central's record subtracts
        ("avg", "central_average", {"column": "age"}, tables),
        ("sec", "central_secure_average", {"column": "age",
                                           "seed_hex": c["secure_seed"]},
         tables),
    )
    ms = {}
    for image, method, kwargs, data in tasks:
        fed.set_datasets("default", data)
        t0 = time.perf_counter()
        task = fed.create_task(image, {"method": method, "kwargs": kwargs},
                               organizations=[0])
        fed.wait_for_results(task.id)
        if fed.mesh.device.type == "cuda":
            torch.cuda.synchronize()
        ms[method] = 1e3 * (time.perf_counter() - t0)
    ids = sorted(fed.tasks)
    records = []
    for i in ids:
        task = fed.tasks[i]
        results = [r.result for r in task.runs]
        if task.method == "partial_secure_average":
            # the upload's masks come from the central's fresh tag
            results = [r["party_index"] for r in results]
        elif task.method == "central_fedavg":  # its model's move
            init = _leaves(W.init_params(3, device=fed.mesh.device))
            results = [dict(losses=r["losses"], move=[
                p - p0 for p, p0 in zip(_leaves(r["params"]), init,
                                        strict=True)]) for r in results]
        records.append(dict(
            name=task.name, method=task.method,
            parent=None if task.parent_id is None
            else ids.index(task.parent_id),
            device=task.stacked_result is not None,
            statuses=[r.status.value for r in task.runs],
            stations=[r.station_index for r in task.runs],
            results=results, stacked=task.stacked_result))
    for r in reversed(records):  # a subtask follows its parent
        if r["device"] and r["parent"] is not None:
            records[r["parent"]]["device"] = True
    return records, ms


def _bits(x):
    """``x`` as a string that is equal only for equal bits (tensors by
    their digest, floats by their repr)."""
    import torch

    if isinstance(x, torch.Tensor):
        return f"tensor({x.dtype}, {list(x.shape)}, {_digest([x])})"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k!r}: {_bits(v)}"
                               for k, v in sorted(x.items())) + "}"
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(_bits(v) for v in x) + "]"
    return repr(x)


def _federation_bits(records):
    """Each record with its results and device rows as ``_bits``."""
    return [{k: _bits(v) if k in ("results", "stacked") else v
             for k, v in r.items()} for r in records]


def _federation_spread(a, b):
    """How far record ``a``'s run results lie from record ``b``'s: the
    largest, over the runs and over each result's fields (a station's
    delta, loss and count; the central's losses and model move), of
    ``|a - b| / |b|`` in the 2-norm of the field's numbers. A structure
    that differs raises."""
    import torch

    def numbers(x):
        if isinstance(x, torch.Tensor):
            return [x.detach().double().reshape(-1).cpu()]
        if isinstance(x, (int, float)):
            return [torch.tensor([float(x)], dtype=torch.float64)]
        if isinstance(x, dict):
            return [t for k in sorted(x) for t in numbers(x[k])]
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in numbers(v)]
        return []

    worst = 0.0
    for ra, rb in zip(a["results"], b["results"], strict=True):
        fields = (sorted(rb) if isinstance(rb, dict) else [None])
        for k in fields:
            xa, xb = numbers(ra if k is None else ra[k]), numbers(
                rb if k is None else rb[k])
            if len(xa) != len(xb) or any(u.shape != v.shape
                                         for u, v in zip(xa, xb)):
                raise ValueError(f"{b['method']}: {k} differs in shape")
            if not xb:
                continue
            u, v = torch.cat(xa), torch.cat(xb)
            num, den = (u - v).norm().item(), v.norm().item()
            worst = max(worst, num / den if den else
                        (0.0 if num == 0 else float("inf")))
    return worst


def _federation_errors(got, want, loop):
    """``got``'s records against ``want``'s (the one-process batched
    form), with ``loop`` (the one-process looped form) measuring what
    batching alone moves: the records without device rows bit for bit
    (the places that differ, with any record whose fields or structure
    differ); each record with device rows, or with a subtask that has
    them, no further from ``want``'s (``_federation_spread``) than
    DIST_FEDERATION's ``spread_factor`` times ``loop``'s is. Returns the
    places, each device record's spread and its bound."""
    c = DIST_FEDERATION
    differ, spreads = [], []
    for i, (a, b, l) in enumerate(zip(got, want, loop, strict=True)):
        if not a["device"]:
            if _federation_bits([a]) != _federation_bits([b]):
                differ.append(i)
            continue
        rest = [{k: v for k, v in r.items() if k not in ("results",
                                                          "stacked")}
                for r in (a, b)]
        if rest[0] != rest[1] or (
                type(a["stacked"]) is not type(b["stacked"])):
            differ.append(i)
            continue
        try:
            got_s, loop_s = _federation_spread(a, b), _federation_spread(l, b)
        except ValueError:
            differ.append(i)
            continue
        spreads.append(dict(record=i, method=b["method"], spread=got_s,
                            bound=c["spread_factor"] * loop_s,
                            batching=loop_s))
    return dict(differ=differ, spreads=spreads)


# one rank of phase 13's two-rank gloo run on the card: joins the group
# with torch.distributed itself (initialize() picks NCCL for a card) and
# runs the device engine's tasks on its own station only
_GLOO_RANK = """
import json, sys, time
import torch
import torch.distributed as dist
rank, world, init, here, device, reference = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5], sys.argv[7])
sys.path.insert(0, here)
import chip_smoke as cs
for name, sizes in json.loads(sys.argv[6]).items():  # the parent's sizes
    getattr(cs, name).update(sizes)
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
# the compressed rounds and the secure sum across the two ranks
from vantage6_tpu_torch.fed import collectives as C
torch.backends.cudnn.deterministic = True
n_s = cs.DIST_COMPRESSED["gloo_stations"]
mesh = cs._looped_mesh(n_s, device, group=dist.group.WORLD)
rows = slice(mesh.local_stations.start, mesh.local_stations.stop)
sx, sy, counts = cs._flagship_data(torch, device, n_s)
t0 = time.perf_counter()
rounds = cs._compressed_rounds(torch, mesh, sx[rows], sy[rows], counts,
                               device)
out["compressed"] = dict(digests=cs._round_digests(rounds),
                         s=time.perf_counter() - t0,
                         stations=list(mesh.local_stations))
c = cs.DIST_COMPRESSED
per = cs.FEDAVG["stations"] // world
vals, mask = cs._secure_values(torch, device,
                               rows=slice(per * rank, per * (rank + 1)))
from vantage6_tpu_torch.core.mesh import FederationMesh
smesh = FederationMesh(2 * vals.shape[0], device=device,
                       group=dist.group.WORLD)
t0 = time.perf_counter()
total = C.secure_sum(vals, c["secure_key"], c["secure_scale"], mask=mask,
                     mesh=smesh)
out["secure_sum"] = dict(digest=cs._digest([total]),
                         s=time.perf_counter() - t0)
# (f) the fused flagship rounds over the two ranks, captured in segments
from vantage6_tpu_torch.fed.fedavg import capture_form
from vantage6_tpu_torch.workloads import fedavg_mnist as W
fc, f = cs.DIST_FUSED, cs.FEDAVG
n_s = fc["gloo_stations"]
fmesh = FederationMesh(n_s, device=device, group=dist.group.WORLD)
rows = slice(fmesh.local_stations.start, fmesh.local_stations.stop)
sx, sy, counts = cs._flagship_data(torch, device, n_s)
eng = W.make_engine(fmesh, local_steps=f["local_steps"],
                    batch_size=f["batch"], local_lr=f["lr"])
params0 = W.init_params(1, device=device)
fused, eager = cs._fused_and_eager(torch, eng, params0, sx[rows], sy[rows],
                                   counts, fc["key"], fc["gloo_rounds"])
def eager_rounds():
    p, o = params0, eng.init(params0)
    gen = torch.Generator(device=device).manual_seed(fc["key"])
    for _ in range(fc["gloo_rounds"]):
        p, o = eng.round(p, o, sx[rows], sy[rows], counts, key=gen)[:2]
def sync():
    if device == "cuda":
        torch.cuda.synchronize()
ms = {}
for name, fn in (("fused", lambda: eng.run_rounds(
        params0, sx[rows], sy[rows], counts, fc["key"], fc["gloo_rounds"])),
                 ("eager", eager_rounds)):
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    ms[name] = 1e3 * (time.perf_counter() - t0) / fc["gloo_rounds"]
fr = list(eng._fused.values())[-1]
out["fused"] = dict(form=capture_form(torch.device(device),
                                      dist.group.WORLD),
                    segments=len(fr.segments), cuts=len(fr.cuts),
                    fused=cs._run_digests(fused), eager=cs._run_digests(eager),
                    ms_per_round=ms, capture=eng.last_capture,
                    stations=list(fmesh.local_stations))
del eng, fused, eager, fr
# (g) the transformer engine over the two ranks, 2 stations a rank
from vantage6_tpu_torch.ops import flash_attention as fa
from vantage6_tpu_torch.workloads import fed_transformer as ft
teng, tokens, params, opt = cs._transformer_engine(ft, torch, device,
                                                   dist.group.WORLD)
params, losses, tms, peak, launches = cs._transformer_rounds(
    fa, torch, teng, tokens, params, opt)
ref = torch.load(reference, weights_only=True)
out["transformer"] = dict(
    losses=losses, ref_losses=ref["losses"], round_ms=tms, peak_mem_gb=peak,
    launches=launches, stations=list(teng.mesh.local_stations),
    tokens=list(tokens.shape),
    param_max_abs_err=max((a.float().cpu() - b).abs().max().item()
                          for a, b in zip(cs._leaves(params), ref["params"],
                                          strict=True)))
del teng, tokens, params, opt, ref
if device == "cuda":
    torch.cuda.empty_cache()
# (h) a Federation over the two ranks; rank 0 also runs the one-process
# one. The batched device steps first, as users run them, then each
# station's step on its own (_looped_mesh), every form on both ranks
from vantage6_tpu_torch.runtime.federation import (
    Federation, federation_from_datasets)
from vantage6_tpu_torch.workloads import average, secure_average
executed = []
_execute = Federation._execute_host
def counting(self, task, fn, run, trace_parent=None):
    if self.mesh.group is not None:
        executed.append((task.method, run.station_index))
    return _execute(self, task, fn, run, trace_parent)
Federation._execute_host = counting
_fed_map = FederationMesh.fed_map
def looped(self, fn, *args, replicated_args=(), batched=False):
    return _fed_map(self, fn, *args, replicated_args=replicated_args)
hc = cs.DIST_FEDERATION
sx, sy, counts = cs._flagship_data(torch, device, hc["stations"])
images = [{"x": sx[i], "y": sy[i], "count": counts[i],
           "sid": torch.tensor(i, dtype=torch.int32, device=device)}
          for i in range(hc["stations"])]
tables = cs._federation_tables(hc["stations"])
algos = {"fedavg": W, "avg": average, "sec": secure_average}
out["federation"], kept = {}, {}
forms = ["ranks", "ranks-looped"] + (["one", "one-looped"] if rank == 0
                                     else [])
for form in forms:
    kw = {"group": dist.group.WORLD} if form.startswith("ranks") else {}
    executed.clear()
    FederationMesh.fed_map = looped if form.endswith("looped") else _fed_map
    fed = federation_from_datasets(images, algos, device=device,
                                   executor_workers=8, **kw)
    try:
        records, ms = cs._federation_program(torch, fed, images, tables)
    finally:
        fed.close()
        FederationMesh.fed_map = _fed_map
    out["federation"][form] = dict(bits=cs._federation_bits(records), ms=ms,
                                   executed=list(executed))
    if form in ("ranks", "one", "one-looped"):
        kept[form] = records
    del fed, records
if rank == 0:
    out["federation"]["errors"] = cs._federation_errors(
        kept["ranks"], kept["one"], kept["one-looped"])
del kept
dist.destroy_process_group()
print(json.dumps(out, default=str))
"""


def _dist_compressed(torch, dev, gmesh, plain, backend, sx, sy, counts):
    """Phase 13's compressed rounds and secure sum on the group of one
    rank against the plain mesh, bit for bit, each timed in turns (plain,
    group, group, plain)."""
    from vantage6_tpu_torch.fed import collectives as C

    c = DIST_COMPRESSED

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        digests, round_ms = {}, {"plain": [], backend: []}
        for which in ("plain", backend, backend, "plain"):
            sync()
            t0 = time.perf_counter()
            rounds = _compressed_rounds(
                torch, plain if which == "plain" else gmesh, sx, sy,
                counts, dev)
            sync()
            round_ms[which].append(
                1e3 * (time.perf_counter() - t0) / c["rounds"])
            digests[which] = _round_digests(rounds)
        differ = _digests_differ(digests[backend], digests["plain"])
        same = not differ
        check(same, f"the compressed rounds on the {backend} mesh differ "
                    f"from the plain mesh's at (round, field) {differ}")
        loss = [float(r[2]) for r in rounds]
        del rounds
        vals, mask = _secure_values(torch, dev)
        sums, sum_ms = {}, {"plain": [], backend: []}
        for which in ("plain", backend, backend, "plain"):
            kw = {} if which == "plain" else {"mesh": gmesh}
            sync()
            t0 = time.perf_counter()
            total = C.secure_sum(vals, c["secure_key"], c["secure_scale"],
                                 mask=mask, **kw)
            sync()
            sum_ms[which].append(1e3 * (time.perf_counter() - t0))
            sums[which] = _digest([total])
        same_sum = sums["plain"] == sums[backend]
        check(same_sum, f"secure_sum on the {backend} mesh differs from "
                        "the one-process sum")
        plain_sum = (vals.double() * mask.to(dev).double()[:, None]).sum(0)
        err = (total.double() - plain_sum).abs().max().item()
        lim = vals.shape[0] * 0.5 / c["secure_scale"]
        check(err <= lim, f"secure_sum off the plain sum by {err} > {lim}")
        del vals, total
    finally:
        torch.backends.cudnn.deterministic = deterministic
    res = dict(
        rounds=dict(bit_identical=same, losses=loss,
                    ms_per_round={k: sorted(v)[0]
                                  for k, v in round_ms.items()},
                    runs_ms=round_ms),
        secure_sum=dict(bit_identical=same_sum, max_abs_err=err, tol=lim,
                        ms={k: sorted(v)[0] for k, v in sum_ms.items()},
                        runs_ms=sum_ms, digest=sums["plain"]))
    print(f"compressed fedavg ({COMPRESSOR}) x {c['rounds']} rounds on the "
          f"{backend} mesh == plain mesh bit for bit (losses {loss}); "
          f"ms/round {backend} {res['rounds']['ms_per_round'][backend]:.3f},"
          f" plain {res['rounds']['ms_per_round']['plain']:.3f} (best of 2 "
          f"turns); secure_sum [{FEDAVG['stations']}, {c['secure_values']}]"
          f" on the {backend} mesh == one-process sum bit for bit, "
          f"{res['secure_sum']['ms'][backend]:.3f} ms vs "
          f"{res['secure_sum']['ms']['plain']:.3f} ms (best of 2 turns), "
          f"max |err| vs the plain f64 sum {err:.3e} (tol {lim:.3e})")
    return res


def _gloo_compressed_reference(torch, dev):
    """The one-process form of the gloo ranks' compressed rounds: the
    digests each rank must match (its EF rows)."""
    n_s = DIST_COMPRESSED["gloo_stations"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sx, sy, counts = _flagship_data(torch, dev, n_s)
        rounds = _compressed_rounds(torch, _looped_mesh(n_s, dev), sx, sy,
                                    counts, dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    per = n_s // 2
    return [_round_digests(rounds, ef_rows=slice(per * r, per * (r + 1)))
            for r in range(2)]


def _gloo_two_ranks(dev, reference, timeout=420):
    """Phase 13's arms over two gloo ranks on ``dev`` (both on the one
    card), each rank a child process: the device-engine tasks on its own
    station, the compressed rounds and the secure sum, and (f)-(h), the
    transformer's held to the one-card run at ``reference``. Returns (each
    rank's results, wall seconds); a rank that fails or outlives
    ``timeout`` fails the phase, and every child is stopped."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        t0 = time.perf_counter()
        # (h)'s secure average masks with the numpy form of the native
        # masks: phase 15 builds and holds the library itself
        env = dict(os.environ, V6T_DISABLE_NATIVE="1")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _GLOO_RANK, str(r), "2", init, HERE,
             dev.type, json.dumps(dict(
                 DISTRIBUTED=DISTRIBUTED, FEDAVG=FEDAVG,
                 DIST_COMPRESSED=DIST_COMPRESSED, DIST_FUSED=DIST_FUSED,
                 DIST_TRANSFORMER=DIST_TRANSFORMER, FULL=FULL,
                 DIST_FEDERATION=DIST_FEDERATION)), reference],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env) for r in range(2)]
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

    import shutil
    import tempfile

    from vantage6_tpu_torch.workloads import fed_transformer as ft

    cfg, fcfg = DISTRIBUTED, FEDAVG
    res = {}
    tmp = tempfile.mkdtemp(prefix="v6t-phase13-")
    reference = os.path.join(tmp, "transformer.pt")  # (g)'s one-card run
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
        del outs, a, b, eng_plain, eng_group
        res["compressed"] = _dist_compressed(torch, dev, gmesh, plain,
                                             backend, sx, sy, counts)
        res["fused"] = _dist_fused(torch, dev, gmesh, plain, backend, sx, sy,
                                   counts)
        del sx, sy

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
        before = dict(fa.flash_forward_cuda.variant_launches)
        check(sum(before.values()) == 0,
              f"phase 13 launched a flash kernel before (g): {before}")
        # (g) the transformer engine over the group, phase 4's width
        res["transformer"] = _dist_transformer(
            fa, ft, torch, dev, gmesh.group, backend, reference)
    finally:
        D.shutdown()
        for key in env:
            os.environ.pop(key, None)
    check(not D.is_initialized(), "the process group outlived phase 13")
    launches = dict(fa.flash_forward_cuda.variant_launches)

    # two gloo ranks on the one card (gloo takes CUDA tensors for the
    # collectives these tasks use; NCCL cannot put two ranks on one card)
    try:
        outs, wall = _gloo_two_ranks(dev, reference)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref = _gloo_compressed_reference(torch, dev)
    n_s = DIST_COMPRESSED["gloo_stations"]
    for r, o in enumerate(outs):
        differ = _digests_differ(o["compressed"]["digests"], ref[r])
        check(o["compressed"]["stations"]
              == list(range(r * n_s // 2, (r + 1) * n_s // 2))
              and len(o["compressed"]["digests"]) == len(ref[r])
              and not differ,
              f"gloo rank {r}: the compressed rounds differ from the "
              f"one-process rounds at (round, field) {differ}")
        check(o["secure_sum"]["digest"]
              == res["compressed"]["secure_sum"]["digest"],
              f"gloo rank {r}: secure_sum differs from the one-process sum")
    res["gloo_compressed"] = dict(
        bit_identical=True, stations=n_s,
        rounds_s=[o["compressed"]["s"] for o in outs],
        secure_sum_s=[o["secure_sum"]["s"] for o in outs])
    print(f"over two gloo ranks on {dev}: {DIST_COMPRESSED['rounds']} "
          f"compressed rounds of {n_s} stations ({n_s // 2} a rank) == the "
          "one-process rounds bit for bit (params, each rank's EF rows, "
          "loss, stats), "
          f"{res['gloo_compressed']['rounds_s']} s; secure_sum of "
          f"[{FEDAVG['stations']}, {DIST_COMPRESSED['secure_values']}] "
          f"({FEDAVG['stations'] // 2} a rank) == the one-process sum bit "
          "for bit, "
          f"{res['gloo_compressed']['secure_sum_s']} s")
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
    res["gloo_fused"] = _gloo_fused_checks(outs, dev)
    res["gloo_transformer"] = _gloo_transformer_checks(outs, dev)
    res["gloo_federation"] = _gloo_federation_checks(outs, dev)
    # this process's flash launches: (g)'s run over the group alone
    check(launches == res["transformer"]["launches"],
          f"phase 13 launched {launches} besides (g)'s rounds "
          f"{res['transformer']['launches']}")
    res["launches"] = launches
    return res


def _gloo_fused_checks(outs, dev):
    """Phase 13 (f) over the gloo ranks: the segmented fused rounds equal
    the eager rounds on each rank, bit for bit."""
    c = DIST_FUSED
    # on the CPU (where the phase is rehearsed) the round runs eagerly
    form = "segments" if dev.type == "cuda" else "eager"
    for r, o in enumerate(outs):
        f = o["fused"]
        differ = _digests_differ([f["fused"]], [f["eager"]])
        check(f["form"] == form and not differ
              and (form == "eager" or f["segments"] == f["cuts"] + 1 > 1),
              f"gloo rank {r}: the {f['form']} fused rounds ({f['segments']}"
              f" graphs) differ from the eager rounds at {differ}")
    res = dict(rounds=c["gloo_rounds"], stations=c["gloo_stations"],
               form=form, segments=outs[0]["fused"]["segments"],
               bit_identical=True,
               ms_per_round=[o["fused"]["ms_per_round"] for o in outs],
               capture=[o["fused"]["capture"] for o in outs])
    print(f"fused flagship rounds over two gloo ranks on {dev} "
          f"({c['gloo_stations']} stations, {c['gloo_stations'] // 2} a rank):"
          f" captured in {res['segments']} graphs cut at each collective; "
          f"{c['gloo_rounds']} segmented rounds == {c['gloo_rounds']} eager "
          f"rounds over the same group bit for bit on each rank; ms/round "
          f"(fused, eager) {res['ms_per_round']}; capture {res['capture']}")
    return res


def _gloo_transformer_checks(outs, dev):
    """Phase 13 (g) over the gloo ranks: each rank's rounds against the
    one-card run, within DIST_TRANSFORMER's tolerances; its kernels."""
    c = DIST_TRANSFORMER
    expect = (c["rounds"] * (FULL["stations"] // 2) * FULL["n_layers"]
              if dev.type == "cuda" else 0)
    for r, o in enumerate(outs):
        t = o["transformer"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(t["losses"],
                                                       t["ref_losses"]))
        t["loss_max_rel_err"] = rel
        check(t["stations"] == [2 * r, 2 * r + 1]
              and rel <= c["loss_rtol"]
              and t["param_max_abs_err"] <= c["param_atol"],
              f"gloo rank {r}: the transformer rounds are off the one-card "
              f"run: loss rel {rel:.3e}, params "
              f"{t['param_max_abs_err']:.3e}")
        check(t["launches"].get("tensor_core", 0) == expect
              == sum(t["launches"].values()),
              f"gloo rank {r} launched {t['launches']}, not {expect} "
              "tensor_core kernels")
    res = [o["transformer"] for o in outs]
    for r, t in enumerate(res):
        print(f"transformer engine over two gloo ranks on {dev}, rank {r} "
              f"(stations {t['stations']}, tokens {t['tokens']}): losses "
              f"{t['losses']} (one card {t['ref_losses']}, max rel "
              f"{t['loss_max_rel_err']:.3e} <= {c['loss_rtol']:.0e}), params"
              f" max |err| {t['param_max_abs_err']:.3e} <= "
              f"{c['param_atol']:.0e}; ms/round "
              f"{[round(x, 1) for x in t['round_ms']]}, peak "
              f"{t['peak_mem_gb']} GB, flash launches {t['launches']}")
    print("the ring at seq_devices = 2 across ranks cannot run on this card:"
          " NCCL refuses two ranks on one device and gloo refuses CUDA "
          "send/recv; tests/test_torch_fed_transformer_mp.py holds it on 4 "
          "gloo ranks on the CPU")
    return res


def _gloo_federation_checks(outs, dev):
    """Phase 13 (h): both ranks hold the same records, bit for bit; with
    the batched device steps they are the one-process Federation's within
    DIST_FEDERATION's tolerance where device rows enter, bit for bit
    elsewhere; with each station's step on its own every record is the
    one-process one's, bit for bit; each host run executed once, on its
    station's rank."""
    c = DIST_FEDERATION
    fed = [o["federation"] for o in outs]
    one = fed[0]["one"]["bits"]
    per = c["stations"] // 2
    for form in ("ranks", "ranks-looped"):
        check(fed[0][form]["bits"] == fed[1][form]["bits"],
              f"the gloo ranks' {form} records differ")
        executed = [(m, s, r) for r, f in enumerate(fed)
                    for m, s in f[form]["executed"]]
        want = sorted((rec["method"], s) for rec in one
                      for s in rec["stations"] if rec["stacked"] == "None")
        check(sorted((m, s) for m, s, _ in executed) == want
              and all(s // per == r for _, s, r in executed),
              f"{form}: a host run did not execute once, on its station's "
              "rank")
    looped = fed[0]["ranks-looped"]["bits"]
    differ = [i for i, (a, b) in enumerate(zip(looped,
                                               fed[0]["one-looped"]["bits"]))
              if a != b]
    check(len(looped) == len(one) and not differ,
          f"each station's step on its own: the records differ from the "
          f"one-process ones at {differ[:5]}")
    err = fed[0]["errors"]
    far = [s for s in err["spreads"] if not s["spread"] <= s["bound"]]
    check(not err["differ"] and not far,
          f"batched: the records differ from the one-process ones at "
          f"{err['differ'][:5]}, or lie further than their bound: {far}")
    ms = {"ranks": fed[0]["ranks"]["ms"], "one_process": fed[0]["one"]["ms"],
          "ranks_looped": fed[0]["ranks-looped"]["ms"],
          "one_process_looped": fed[0]["one-looped"]["ms"]}
    n_device = sum(rec["device"] for rec in one)
    res = dict(stations=c["stations"], records=len(one), device_records=n_device,
               host_runs=len(executed), errors=err, ms=ms,
               ms_rank1=fed[1]["ranks"]["ms"],
               looped_bit_identical=True)
    rounded = {k: {m: round(t, 1) for m, t in v.items()}
               for k, v in ms.items()}
    print(f"Federation over two gloo ranks on {dev} ({c['stations']} "
          f"stations, {per} a rank): {len(one)} task records, the same bits"
          f" on both ranks; batched device steps: the {len(one) - n_device} "
          f"host records == the one-process Federation's bit for bit, the "
          f"{n_device} with device rows "
          + ", ".join(f"{s['method']} {s['spread']:.3e} (batching alone "
                      f"{s['batching']:.3e})" for s in err["spreads"])
          + f" in norm; each station's step on its own: every record"
          f" == the one-process one bit for bit; {len(executed)} host runs "
          f"a form, each once on its station's rank; ms a task over the "
          f"ranks {rounded['ranks']} vs one process "
          f"{rounded['one_process']} (looped {rounded['ranks_looped']} vs "
          f"{rounded['one_process_looped']})")
    return res


# ------------------------------------------------------------------ phase 14
OPS = dict(
    # (a) the reference benchmark's straggler arm (bench.py:2692-2770)
    stations=8, rows=128, rounds=30, quorum=7, over_select=1,
    # rounds/s: the clean and the buffered arm timed in turns, one run of
    # 30 rounds each a pair, 7 pairs; the resilience is the median of the
    # pairs' ratios
    pairs=7,
    slow_rounds=2,   # sync rounds under the straggler (each waits for it)
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
    """Whether ``requests``, ``cryptography``, ``click`` and ``yaml``
    (PyYAML) import here."""
    import importlib

    found = {}
    for name in ("requests", "cryptography", "click", "yaml"):
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

    def timed(one_round, vals):
        """rounds/s of one run of ``rounds`` rounds; their values go to
        ``vals``."""
        t0 = time.perf_counter()
        vals += [one_round() for _ in range(rounds)]
        return rounds / (time.perf_counter() - t0)

    FAULTS.clear()
    # the arms take milliseconds: time them with the collector off, as
    # timeit does (a full collection of this process's heap takes longer)
    gc.collect()
    gc.disable()
    sync_round()  # untimed
    vals_clean = []
    first_clean = timed(sync_round, vals_clean)
    # the "10x-slow station": ~9 extra clean-round times, clamped
    delay_s = min(1.0, max(0.2, 9.0 / first_clean))
    fault = f"delay:station=0,seconds={delay_s:.3f}"
    FAULTS.configure(fault)
    n_slow = c["slow_rounds"]
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

    async_round()  # untimed
    # the two arms in turns, so that the host's drift moves both alike:
    # clean (no fault), buffered (the straggler), clean, buffered, ...
    clean_runs, async_runs, vals_async = [], [], []
    for _ in range(c["pairs"]):
        FAULTS.clear()
        # untimed: a sync round waits out the straggler the buffered arm
        # left running on station 0's queue
        sync_round()
        clean_runs.append(timed(sync_round, vals_clean))
        FAULTS.configure(fault)
        async_runs.append(timed(async_round, vals_async))
    gc.enable()
    fault_snapshot = FAULTS.snapshot()
    FAULTS.clear()
    staleness = fed.station_staleness()
    fed.close()
    ratios = [100.0 * a / b for a, b in zip(async_runs, clean_runs)]
    print("ops straggler pairs (clean, buffered rounds/s, ratio %): "
          + ", ".join(f"({b:.1f}, {a:.1f}, {r:.1f})"
                      for b, a, r in zip(clean_runs, async_runs, ratios)))
    resilience = float(np.median(ratios))
    rps_clean = float(np.median(clean_runs))
    rps_async = float(np.median(async_runs))
    mean_clean, mean_async = float(np.mean(vals_clean)), float(
        np.mean(vals_async))
    agg_rel_err = abs(mean_async - mean_clean) / max(abs(mean_clean), 1e-9)
    res = dict(stations=n_s, rounds=rounds, pairs=c["pairs"],
               delay_s=delay_s, clean_rounds_per_s=rps_clean,
               clean_runs=clean_runs, sync_straggler_rounds_per_s=rps_slow,
               async_rounds_per_s=rps_async, async_runs=async_runs,
               pair_ratios_pct=ratios,
               resilience_pct=resilience, stragglers_killed=killed,
               max_staleness=max_stale,
               staleness_after=staleness, aggregate_rel_err=agg_rel_err,
               fault_snapshot=fault_snapshot)
    print(f"ops straggler: clean {rps_clean:.2f} rounds/s, sync with a "
          f"{delay_s:.3f} s straggler {rps_slow:.2f}, run_buffered "
          f"{rps_async:.2f} (medians of {c['pairs']} pairs; resilience, "
          f"the median of the pairs' ratios, {resilience:.1f}% vs "
          f"{AP_RESILIENCE_PCT:g}), "
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
# (b)'s and (d)'s daemons push fleet telemetry every 5 s, a third of the
# default 15 s, so that each has pushed before it stops and (e) reads it
# back; (c)'s push at the default 15 s, and its loaded fan-out fires one
# push of each
CONTROL = dict(daemons=8, tasks=40, width=2, rows=32, seed=7, turns=3,
               profile_seconds=4.0, fleet_push_interval=5.0,
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


def _fanout_hops(c, task_id, subtasks, t_submit, t_result, label):
    """Where the fan-out's wall time went, in ms, from the server's run
    stamps (``assigned_at`` by the server, ``started_at`` and
    ``finished_at`` by the daemons, one host clock): the researcher's
    submit to node A's claim of the central run, the central's start to
    its last subtask created, each subtask's claim (created -> active: the
    event, the REST claim, the activation) and run (active -> finished:
    the CSV load and the partial), the central's wait from the last
    partial's finish to its own, and the researcher's wake-up. Printed on
    a line of its own."""
    (central,) = c.run.from_task(task_id)
    subs = [r for t in subtasks for r in c.run.from_task(t["id"])]
    assigned = [r["assigned_at"] for r in subs]
    claim = [1e3 * (r["started_at"] - r["assigned_at"]) for r in subs]
    run = [1e3 * (r["finished_at"] - r["started_at"]) for r in subs]
    last_done = max(r["finished_at"] for r in subs)
    hops = dict(
        submit_to_claim=1e3 * (central["started_at"] - t_submit),
        central_to_subtasks=1e3 * (max(assigned) - central["started_at"]),
        subtask_claim_p50=float(np.median(claim)),
        subtask_claim_max=max(claim),
        subtask_run_p50=float(np.median(run)),
        subtask_run_max=max(run),
        subtasks_span=1e3 * (last_done - min(assigned)),
        central_wait_after_last=1e3 * (central["finished_at"] - last_done),
        result_to_researcher=1e3 * (t_result - central["finished_at"]),
    )
    slowest = max(subs, key=lambda r: r["finished_at"] - r["assigned_at"])
    hops["slowest_subtask_org"] = (slowest.get("organization") or {}).get(
        "id")
    print(f"central fan-out hops, {label} (ms): " + ", ".join(
        f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in hops.items()))
    return hops


class _ServerSplit:
    """Where a ``ServerApp``'s handlers spend their time in the fleet
    store, installed on its ``server.fleet`` module, its route table and
    its in-memory database: ``health_block`` (``GET /api/health``'s
    aggregate, its own ``sources`` call included), ``sources`` outside it
    (the watchdog tick's), the push ingest (``ingest_insert``, whose calls
    are the pushes ingested) and its prunes, and the database lock: the
    wait to take it and the time it is held (outermost holds only), each
    hold and wait also under its caller (``METHOD /api/route`` for a
    request's handler, the thread's name outside a request) and each hold
    under its statement. Each key has calls, total ms and max ms since the
    last ``window``. ``close`` removes it."""

    def __init__(self, srv):
        import threading

        from vantage6_tpu_torch.server import fleet

        self.fleet, self.db, self.local = fleet, srv.db, threading.local()
        self.app, self.mu = srv.app, threading.Lock()
        self.thread = threading.current_thread
        self.orig = {k: getattr(fleet, k)
                     for k in ("health_block", "sources", "ingest", "prune")}
        self.window()

        def timed(key, fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.add(key, time.perf_counter() - t0)
            return wrapper

        def health_block(*args, **kwargs):
            self.local.in_health = True
            try:
                return timed("health_block", self.orig["health_block"])(
                    *args, **kwargs)
            finally:
                self.local.in_health = False

        def sources(*args, **kwargs):
            if getattr(self.local, "in_health", False):
                return self.orig["sources"](*args, **kwargs)
            return timed("sources", self.orig["sources"])(*args, **kwargs)

        def ingest(*args, **kwargs):
            self.local.prune_s = 0.0
            t0 = time.perf_counter()
            try:
                return self.orig["ingest"](*args, **kwargs)
            finally:
                self.add("ingest_insert", time.perf_counter() - t0
                         - self.local.prune_s)

        def prune(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return self.orig["prune"](*args, **kwargs)
            finally:
                s = time.perf_counter() - t0
                self.local.prune_s = getattr(self.local, "prune_s", 0.0) + s
                self.add("prune", s)

        fleet.health_block, fleet.sources = health_block, sources
        fleet.ingest, fleet.prune = ingest, prune
        # the caller of every hold a request makes, its auth included:
        # the route whose pattern matches, as the app matches it
        orig_handle, routes = self.app.handle, self.app._routes

        def handle(request):
            self.local.caller = next(
                (f"{request.method} {pattern}" for regex, _, pattern in routes
                 if regex.match(request.path)), f"{request.method} ?")
            try:
                return orig_handle(request)
            finally:
                self.local.caller = None

        self.app.handle = handle
        self.lock = srv.db._memory_lock
        if self.lock is not None and srv.db._memory_conn is not None:
            srv.db._memory_lock = _TimedLock(self.lock, self)
            # the holder's statement: the one that took the lock (a batch's
            # first)
            for name in ("execute", "query", "execute_batch"):
                setattr(srv.db, name, self._labelled(getattr(srv.db, name),
                                                     name == "execute_batch"))

    def _labelled(self, method, batch):
        def call(sql, params=()):
            first = sql[0][0] if batch and sql else sql
            self.local.sql = " ".join(str(first).split()[:4])[:48]
            return method(sql) if batch else method(sql, params)
        return call

    def caller(self):
        return (getattr(self.local, "caller", None)
                or "thread " + self.thread().name)

    def add(self, key, seconds):
        with self.mu:
            n, total, top = self.stats.get(key, (0, 0.0, 0.0))
            self.stats[key] = (n + 1, total + seconds, max(top, seconds))

    def window(self):
        """The split since the last call (calls, ms, max ms a key); starts
        the next window."""
        with self.mu:
            out, self.stats = getattr(self, "stats", {}), {}
        return {k: dict(calls=n, ms=1e3 * s, max_ms=1e3 * top)
                for k, (n, s, top) in sorted(out.items())}

    def rows(self):
        return int(self.db.query(
            "SELECT COUNT(*) AS n FROM fleet_metric")[0]["n"])

    def close(self):
        for k, fn in self.orig.items():
            setattr(self.fleet, k, fn)
        del self.app.handle
        if isinstance(self.db._memory_lock, _TimedLock):
            self.db._memory_lock = self.lock
            del self.db.execute, self.db.query, self.db.execute_batch


class _TimedLock:
    """A reentrant lock that reports the wait to take it and the time it
    is held (outermost acquisitions only) to a ``_ServerSplit``, in all
    and by caller and statement."""

    def __init__(self, lock, split):
        import threading

        self.lock, self.split, self.local = lock, split, threading.local()

    def __enter__(self):
        t0 = time.perf_counter()
        self.lock.acquire()
        depth = getattr(self.local, "depth", 0)
        if depth == 0:
            self.local.t = time.perf_counter()
            wait = self.local.t - t0
            self.split.add("lock_wait", wait)
            self.split.add("wait\t" + self.split.caller(), wait)
        self.local.depth = depth + 1
        return self

    def __exit__(self, *exc):
        self.local.depth -= 1
        if self.local.depth == 0:
            held = time.perf_counter() - self.local.t
            self.split.add("lock_held", held)
            self.split.add(f"hold\t{self.split.caller()}\t"
                           + getattr(self.split.local, "sql", "?"), held)
        self.lock.release()


def _split_holders(split):
    """The lock's holds and waits of a split window regrouped: by caller
    (holds, with each caller's wait), by statement (with its callers)."""
    def merge(d, key, v):
        n, ms, top = d.get(key, (0, 0.0, 0.0))
        d[key] = (n + v["calls"], ms + v["ms"], max(top, v["max_ms"]))

    by_caller, by_sql, pairs, waits = {}, {}, {}, {}
    for k, v in split.items():
        parts = k.split("\t")
        if parts[0] == "hold":
            merge(by_caller, parts[1], v)
            merge(by_sql, parts[2], v)
            merge(pairs, (parts[2], parts[1]), v)
        elif parts[0] == "wait":
            merge(waits, parts[1], v)

    def ranked(d):
        return [dict(key=k, calls=n, ms=ms, max_ms=top) for k, (n, ms, top)
                in sorted(d.items(), key=lambda kv: -kv[1][1])]

    callers = ranked(by_caller)
    for row in callers:
        n, ms, top = waits.get(row["key"], (0, 0.0, 0.0))
        row.update(wait_ms=ms, wait_max_ms=top)
    statements = ranked(by_sql)
    for row in statements:
        row["callers"] = [
            dict(key=c, calls=n, ms=ms, max_ms=top)
            for (s, c), (n, ms, top) in sorted(
                pairs.items(), key=lambda kv: -kv[1][1]) if s == row["key"]]
    return dict(callers=callers, statements=statements)


def _print_split(label, split, rows):
    """Three lines: the split's figures; the lock's time held by caller
    (the 10 longest, each with its wait); held by statement (the 6
    longest, each with its 3 longest callers)."""
    def fmt(k, v):
        return (f"{k} {v['calls']} calls {v['ms']:.1f} ms "
                f"(max {v['max_ms']:.1f})")

    print(f"server-side split, {label} ({rows} fleet_metric rows): "
          + ", ".join(fmt(k, v) for k, v in split.items() if "\t" not in k))
    holders = _split_holders(split)
    print(f"server-side split, {label}, lock held by caller: " + "; ".join(
        fmt(r["key"], r) + f" waited {r['wait_ms']:.1f} ms"
        for r in holders["callers"][:10]))
    print(f"server-side split, {label}, lock held by statement: "
          + "; ".join(fmt(r["key"], r) + " [" + ", ".join(
              f"{c['key']} {c['ms']:.1f}" for c in r["callers"][:3]) + "]"
              for r in holders["statements"][:6]))
    return holders


def _push_clock(pushes, t0, span):
    """One thread a push: the k-th of ``pushes`` (callables) fires at
    ``t0 + (k + 0.5) span / len(pushes)`` on the perf clock. Returns the
    started threads and the list they append (k, seconds after t0, ok)
    to."""
    import threading

    done = []

    def fire(k, push):
        time.sleep(max(0.0, t0 + (k + 0.5) * span / len(pushes)
                       - time.perf_counter()))
        at = time.perf_counter() - t0
        done.append((k, at, bool(push())))

    threads = [threading.Thread(target=fire, args=(k, p), daemon=True,
                                name=f"push clock {k}")
               for k, p in enumerate(pushes)]
    for th in threads:
        th.start()
    return threads, done


def _fanout(c, collab, orgs, split, label, at_submit=None):
    """One ``central_average`` fan-out through node A, with the server's
    split over it (from submit to result) printed before its hops;
    ``at_submit`` is called once the split's window is open, just before
    the submit. Returns (the result, its record)."""
    rows_before = split.rows()
    split.window()
    if at_submit is not None:
        at_submit()
    t0 = time.perf_counter()
    task = c.task.create(collaboration=collab["id"],
                         organizations=[orgs[0]["id"]],
                         image="v6-average-py",
                         input_={"method": "central_average",
                                 "kwargs": {"column": "f0"}})
    (out,) = c.wait_for_results(task["id"], interval=0.01, timeout=300)
    end = time.time()
    ms = 1e3 * (time.perf_counter() - t0)
    window = split.window()
    rows_after = split.rows()
    holders = _print_split(label, window, rows_after)
    subtasks = [t for t in c.task.list()
                if (t.get("parent") or {}).get("id") == task["id"]]
    hops = _fanout_hops(c, task["id"], subtasks, end - ms / 1e3, end, label)
    pushes = window.get("ingest_insert", {}).get("calls", 0)
    print(f"central fan-out, {label}: {ms:.1f} ms, {pushes} pushes "
          f"ingested, fleet_metric rows {rows_before} -> {rows_after}")
    return out, dict(ms=ms, pushes=pushes, rows_before=rows_before,
                     rows_after=rows_after, server_split=window,
                     holders=holders, hops_ms=hops, subtasks=len(subtasks))


def _cp_fanout(torch, dev, stack, tmp):
    """(c) ``central_average`` over phase 12's registry behind 32 inline
    daemons pushing fleet telemetry at the default 15 s (researcher ->
    node A -> proxy -> 32 subtasks), twice: quiet, before any daemon's
    first push is due, then loaded, with the server's own snapshot and
    each daemon's push fired once, evenly over the first half of the
    quiet fan-out's length; each against the in-process Federation and
    numpy. The
    server's own split (its fleet store and its database lock by caller
    and statement, ``_ServerSplit``) is printed for the daemons' start and
    for each fan-out, before its hops."""
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
    srv, c = stack.srv, stack.client
    split = _ServerSplit(srv)
    try:
        t0 = time.perf_counter()
        # the daemons' default push interval (no fleet_push_interval)
        collab, orgs, daemons = stack.collaboration(
            "registry", csvs,
            {"v6-average-py": "vantage6_tpu_torch.workloads.average"},
            poll_interval=0.05)
        start_s = time.perf_counter() - t0
        start = split.window()
        start_holders = _print_split("daemons' start", start, split.rows())
        quiet_out, quiet = _fanout(c, collab, orgs, split, "quiet")

        def server_tick():
            # the server's own snapshot: its watchdog tick, made due
            srv._fleet_last_push = 0.0
            srv.watchdog.evaluate()
            return True

        clock = []

        def start_clock():
            # over the first half of the quiet fan-out's length: every
            # push lands inside a loaded fan-out up to twice as fast as
            # the quiet one
            clock.extend(_push_clock(
                [server_tick] + [d.fleet.push for d in daemons],
                time.perf_counter(), quiet["ms"] / 2e3))

        loaded_out, loaded = _fanout(c, collab, orgs, split, "loaded",
                                     at_submit=start_clock)
        threads, fired = clock
        for th in threads:
            th.join()
        loaded["fired"] = sorted(fired)
        health = c.util.health()["status"]
        pushed = {s["source"] for s in c.request("GET", "fleet")["sources"]}
    finally:
        split.close()
    late = sum(1 for _, at, _ in fired if 1e3 * at > loaded["ms"])
    loaded.update(health=health, pushes_fired=len(fired),
                  pushes_accepted=sum(ok for *_, ok in fired),
                  fired_after_result=late)
    read_back = {d.name: f"daemon:{d.name}" in pushed for d in daemons}
    print(f"central fan-out, loaded: {len(fired)} pushes fired over "
          f"{quiet['ms'] / 2:.1f} ms ({loaded['pushes_accepted']} accepted, "
          f"{late} after the result), health {health}, "
          f"{sum(read_back.values())} of {len(daemons)} daemons read back "
          f"from /api/fleet")
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
    res = dict(stations=len(f0), patients=int(counts.sum()),
               daemons_start_s=start_s, rest_ms=quiet["ms"],
               server_split={"start": start}, start_holders=start_holders,
               quiet=quiet, loaded=loaded, federation_ms=fed_ms,
               federation=fed_out, numpy=float(pooled.mean()),
               daemons_read_back=read_back)
    for label, out in (("quiet", quiet_out), ("loaded", loaded_out)):
        rel_fed = abs(out["average"] - fed_out["average"]) \
            / abs(fed_out["average"])
        rel_np = abs(out["average"] - pooled.mean()) / abs(pooled.mean())
        res[label].update(rest=out, rel_err_vs_federation=rel_fed,
                          rel_err_vs_numpy=rel_np)
        print(f"central fan-out, {label}: {len(f0)} daemons "
              f"({start_s:.1f} s to start) over {res['patients']} "
              f"patients: REST {res[label]['ms']:.1f} ms, in-process "
              f"Federation {fed_ms:.1f} ms; average {out['average']!r} vs "
              f"Federation {fed_out['average']!r} (rel {rel_fed:.3e}), "
              f"numpy {pooled.mean()!r} (rel {rel_np:.3e}); "
              f"{res[label]['subtasks']} subtask(s)")
        check(out["count"] == fed_out["count"] == pooled.size,
              f"{label} fan-out counts {out['count']}, {fed_out['count']} "
              f"!= {pooled.size}")
        check(rel_fed <= FANOUT_FED_RTOL,
              f"{label} REST average off the Federation's: {rel_fed:.3e}")
        check(rel_np <= FANOUT_NUMPY_RTOL,
              f"{label} REST average off numpy's: {rel_np:.3e}")
    check(loaded["pushes"] >= len(daemons) + 1,
          f"{loaded['pushes']} pushes ingested during the loaded fan-out, "
          f"fewer than its {len(daemons)} daemons and the server")
    check(health == "ok", f"server health {health} after the loaded fan-out")
    check(all(read_back.values()),
          f"daemons not read back from /api/fleet: {read_back}")
    return res


def _jax_shadow(tmp):
    """A directory to put first on a child's ``PYTHONPATH``, holding a
    ``jax`` package whose import writes a marker file and fails:
    (directory, marker path)."""
    shadow = os.path.join(tmp, "shadow")
    os.makedirs(os.path.join(shadow, "jax"), exist_ok=True)
    marker = os.path.join(tmp, "jax_imported")
    with open(os.path.join(shadow, "jax", "__init__.py"), "w") as f:
        f.write(f"open({marker!r}, 'w').close()\n"
                "raise ImportError('jax is blocked in this child')\n")
    return shadow, marker


def _cp_sandbox(stack, tmp):
    """(d) One sandboxed ``partial_average``: a child process that runs
    the port's ``wrap_algorithm`` with the card hidden; ``jax`` shadowed
    by a package that records any import of it."""
    import pandas as pd

    shadow, marker = _jax_shadow(tmp)
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


CLI = dict(rounds=5, seed=0, demo_nodes=3, demo_ports=(7601, 7602),
           start_timeout=120.0, call_timeout=600.0)
CLI_PASSWORD = "p17password123"


# Written into the directory of phase 17's children's ``sitecustomize``:
# each child writes the flash wrapper's launch counts to ``<pid>.json``
# when it exits (at exit, or on the SIGTERM of ``stop``), so the phase
# reads the launches of the processes the CLI ran, not of its own. It then
# runs the ``sitecustomize`` it shadows, if there is one.
_COUNTS_SITE = """\
import atexit, importlib.machinery, importlib.util, json, os, signal, sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def _dump():
    fa = sys.modules.get("vantage6_tpu_torch.ops.flash_attention")
    counts = dict(fa.flash_forward_cuda.variant_launches) if fa else None
    with open(os.path.join({counts!r}, f"{{os.getpid()}}.json"), "w") as f:
        json.dump({{"argv": sys.argv, "launches": counts}}, f)


def _term(signum, frame):
    _dump()
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


atexit.register(_dump)
signal.signal(signal.SIGTERM, _term)
_spec = importlib.machinery.PathFinder.find_spec("sitecustomize", [
    p for p in sys.path if os.path.abspath(p or os.curdir) != _HERE])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
"""


class _CliEnv:
    """The environment every child of phase 17 runs in: the card visible,
    ``jax`` shadowed by a package that records any import of it, the XDG
    roots in a temporary directory, and a ``sitecustomize`` that makes
    each child write its flash launch counts when it exits. Tracks the
    children's pids and kills any detached instance still alive at
    ``close()``."""

    def __init__(self, tmp):
        self.tmp = tmp
        shadow, self.marker = _jax_shadow(tmp)
        self.counts = os.path.join(tmp, "launch_counts")
        site = os.path.join(tmp, "site")
        os.makedirs(self.counts)
        os.makedirs(site)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(_COUNTS_SITE.format(counts=self.counts))
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = os.pathsep.join((shadow, site, HERE))
        for name in ("CONFIG", "DATA", "STATE"):
            self.env[f"XDG_{name}_HOME"] = os.path.join(tmp, name.lower())
        self.pids = {}  # detached instances, by the name a start printed
        self.children = []  # the processes this phase ran itself

    def python(self, *args, cwd=HERE, timeout=None):
        """``python *args`` in this environment: (process, stdout, s)."""
        t0 = time.perf_counter()
        with subprocess.Popen(
                [sys.executable, *args], cwd=cwd, env=self.env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) as proc:
            self.children.append(proc.pid)
            try:
                out, err = proc.communicate(
                    timeout=timeout or CLI["call_timeout"])
            except subprocess.TimeoutExpired:
                proc.kill()
                raise
        proc.stderr_text = err
        return proc, out, time.perf_counter() - t0

    def cli(self, *args, timeout=None):
        """``python -m vantage6_tpu_torch.cli.main *args``: (stdout, s)."""
        proc, out, secs = self.python(
            "-m", "vantage6_tpu_torch.cli.main", *args, timeout=timeout)
        check(proc.returncode == 0,
              f"v6t-torch {' '.join(args)} exited {proc.returncode}: "
              f"{out[-2000:]}{proc.stderr_text[-4000:]}")
        return out, secs

    def started(self, out):
        """Record the pids a start command printed ("... (pid N)")."""
        for line in out.splitlines():
            m = re.search(r"^(.*?) (?:up|started.*) \(pid (\d+)\)", line)
            if m:
                self.pids[m.group(1)] = int(m.group(2))

    def alive(self):
        from vantage6_tpu_torch.cli.main import _alive

        return {k: pid for k, pid in self.pids.items() if _alive(pid)}

    def launches(self, variants):
        """The flash launches of every child, summed per variant, and the
        pids of this phase's own children and instances that wrote no
        count."""
        total, seen = dict.fromkeys(variants, 0), set()
        for name in os.listdir(self.counts):
            with open(os.path.join(self.counts, name)) as f:
                counts = json.load(f)["launches"] or {}
            seen.add(int(name.split(".")[0]))
            for variant, n in counts.items():
                total[variant] += n
        ours = set(self.children) | set(self.pids.values())
        return total, sorted(ours - seen)

    def close(self):
        import signal

        for pid in self.alive().values():
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _wait_online(client, n, timeout):
    """Seconds until ``n`` nodes report online to ``client``'s server."""
    t0 = time.monotonic()
    while True:
        nodes = client.node.list()
        if sum(nd.get("status") == "online" for nd in nodes) >= n:
            return time.monotonic() - t0
        check(time.monotonic() - t0 < CLI["start_timeout"],
              f"{n} node(s) not online after {CLI['start_timeout']} s: "
              f"{[nd.get('status') for nd in nodes]}")
        time.sleep(0.2)


def _wait_health(url, timeout):
    from vantage6_tpu_torch.common.rest import _requests

    requests = _requests()
    t0 = time.monotonic()
    while True:
        try:
            if requests.get(f"{url}/api/health", timeout=1).status_code \
                    == 200:
                return time.monotonic() - t0
        except requests.RequestException:
            pass
        check(time.monotonic() - t0 < timeout,
              f"{url} not healthy after {timeout} s")
        time.sleep(0.1)


def _cli_run(torch, dev, ce):
    """(a) ``v6t-torch run`` of ``central_fedavg`` over phase 6's flagship
    stations, each an ``array`` ``.npz`` database, against the same call
    made in this process."""
    import yaml

    from vantage6_tpu_torch.core.config import FederationConfig
    from vantage6_tpu_torch.runtime.federation import Federation
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    cfg = FEDAVG
    sx, sy, counts = W.make_federated_data(
        cfg["stations"], n_per_station=cfg["per_station"],
        alpha=cfg["alpha"], seed=0, noise=cfg["noise"])
    stations = []
    for i in range(cfg["stations"]):
        path = os.path.join(ce.tmp, f"station_{i:02d}.npz")
        np.savez(path, x=sx[i].numpy(), y=sy[i].numpy(),
                 count=counts[i].numpy(), sid=np.int32(i))
        stations.append({"name": f"station_{i}", "databases": [
            {"label": "default", "type": "array", "uri": path}]})
    fed_yaml = os.path.join(ce.tmp, "fed.yaml")
    with open(fed_yaml, "w") as f:
        yaml.safe_dump({"federation": {"name": "flagship",
                                       "executor_workers": 0},
                        "stations": stations}, f)
    kwargs = {"n_rounds": CLI["rounds"], "seed": CLI["seed"]}
    # the command's default device, the card; the CPU only where this
    # phase is rehearsed on it
    on_cpu = ("--device", "cpu") if dev.type == "cpu" else ()
    out, cli_s = ce.cli("run", fed_yaml, "--image", "v6-fedavg-mnist",
                        "--method", "central_fedavg", "--kwargs",
                        json.dumps(kwargs), *on_cpu)
    cli_losses = [r["losses"] for r in json.loads(out.splitlines()[-1])]

    t0 = time.perf_counter()
    fed = Federation(FederationConfig.load(fed_yaml), device=dev,
                     algorithms={"v6-fedavg-mnist": W})
    try:
        fed.load_all_data()
        task = fed.create_task("v6-fedavg-mnist", {
            "method": "central_fedavg", "kwargs": kwargs})
        results = fed.wait_for_results(task.id)
    finally:
        fed.close()
    torch.cuda.synchronize()
    own_s = time.perf_counter() - t0
    own_losses = [r["losses"] for r in results]
    same = cli_losses == own_losses
    res = dict(stations=len(stations), centrals=len(cli_losses),
               command_s=cli_s, in_process_s=own_s, losses=cli_losses[0],
               bit_identical=same)
    print(f"v6t-torch run: central_fedavg x {len(cli_losses)} centrals over "
          f"{len(stations)} npz stations, {CLI['rounds']} rounds: command "
          f"{cli_s:.1f} s, in-process {own_s:.1f} s; losses "
          f"{cli_losses[0]}, equal to the in-process call's bit for bit "
          f"{same}")
    check(len(cli_losses) == cfg["stations"] and same,
          f"v6t-torch run's losses differ from the in-process call's: "
          f"{cli_losses[0]} vs {own_losses[0] if own_losses else None}")
    check(all(np.isfinite(cli_losses[0])) and
          cli_losses[0][-1] < cli_losses[0][0],
          f"central_fedavg's loss did not fall: {cli_losses[0]}")
    return res


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_node(torch, dev, ce):
    """(b) A server and a node started by ``v6t-torch``, the node's YAML
    given ``device_engine: {}``, phase 13's station behind it; the device
    engine's tasks through a ``UserClient`` against direct calls."""
    import pandas as pd
    import yaml

    from vantage6_tpu_torch.client import UserClient
    from vantage6_tpu_torch.workloads import device_engine as DE

    dcfg, n = DISTRIBUTED, DISTRIBUTED["rows"]
    cols, features = _engine_station(0)
    csv = os.path.join(ce.tmp, "engine_station.csv")
    pd.DataFrame(cols).to_csv(csv, index=False)
    df = pd.read_csv(csv)
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    ce.cli("server", "new", "--name", "p17_server", "--port", str(port))
    entities = os.path.join(ce.tmp, "entities.yaml")
    with open(entities, "w") as f:
        yaml.safe_dump({
            "organizations": [{"name": "p17_org"}],
            "users": [{"username": "p17_researcher",
                       "password": CLI_PASSWORD, "organization": "p17_org",
                       "roles": ["Root"]}],
            "collaborations": [{"name": "p17", "participants": ["p17_org"]}],
        }, f)
    out, _ = ce.cli("server", "import", "p17_server", entities)
    (node,) = json.loads(out.splitlines()[-1])["nodes"]
    ce.cli("node", "new", "--name", "p17_node", "--api-url", url,
           "--api-key", node["api_key"], "--database", f"default:csv:{csv}")
    out, _ = ce.cli("node", "files", "p17_node")
    files = dict(line.split(":", 1) for line in out.splitlines())
    node_yaml, log_dir = files["config"].strip(), files["log"].strip()
    with open(node_yaml) as f:
        conf = yaml.safe_load(f)
    conf.update(algorithms={"device-engine":
                            "vantage6_tpu_torch.workloads.device_engine"},
                device_engine={} if dev.type == "cuda" else {"device": "cpu"},
                runner={"mode": "inline"})
    with open(node_yaml, "w") as f:
        yaml.safe_dump(conf, f)

    t0 = time.perf_counter()
    out, _ = ce.cli("server", "start", "p17_server")
    ce.started(out)
    _wait_health(url, CLI["start_timeout"])
    out, _ = ce.cli("node", "start", "p17_node")
    ce.started(out)
    c = UserClient(url)
    c.authenticate("p17_researcher", CLI_PASSWORD)
    _wait_online(c, 1, CLI["start_timeout"])
    up_s = time.perf_counter() - t0
    collab = next(x for x in c.collaboration.list() if x["name"] == "p17")
    org = next(x for x in c.organization.list() if x["name"] == "p17_org")
    calls = {"device_column_stats": dict(column="age", pad_to=n)}
    for mode in AGG_MODES:
        calls[f"device_logistic_fit_{mode}"] = dict(
            feature_columns=features, label_column="label",
            rounds=dcfg["rounds"], local_steps=dcfg["local_steps"],
            batch_rows=n, lr=dcfg["lr"], agg_mode=mode)
    res = {"up_s": up_s, "calls": {}}
    for name, kwargs in calls.items():
        method = name if name == "device_column_stats" \
            else "device_logistic_fit"
        t0 = time.perf_counter()
        t = c.task.create(collaboration=collab["id"],
                          organizations=[org["id"]], image="device-engine",
                          engine="device",
                          input_={"method": method, "kwargs": kwargs})
        (rest,) = c.wait_for_results(t["id"], interval=0.01, timeout=300)
        rest_ms = 1e3 * (time.perf_counter() - t0)
        direct = getattr(DE, method).__wrapped__(df, device=dev, **kwargs)
        torch.cuda.synchronize()
        res["calls"][name] = dict(rest_ms=rest_ms,
                                  bit_identical=rest == direct)
        print(f"CLI node device engine {name}: submit->result "
              f"{rest_ms:.1f} ms, equal to the direct call bit for bit "
              f"{rest == direct}")
        check(rest == direct, f"{name} through the CLI's node differs from "
                              f"the direct call: {rest} vs {direct}")
    with open(os.path.join(log_dir, "stdout.log")) as f:
        log = f.read()
    card = (f"cuda:0 ({torch.cuda.get_device_name(0)})"
            if dev.type == "cuda" else "cpu")
    res["log_names_card"] = f"device engine on {card}" in log
    check(res["log_names_card"], f"the node's log does not name {card}")
    for kind, name in (("node", "p17_node"), ("server", "p17_server")):
        out, _ = ce.cli(kind, "stop", name)
        check(out.strip().endswith("stopped"), f"{kind} stop: {out}")
    res["alive_after_stop"] = ce.alive()
    print(f"CLI node: server + node up in {up_s:.1f} s, the node's log "
          f"names {card}: {res['log_names_card']}; alive after stop "
          f"{res['alive_after_stop']}")
    check(not res["alive_after_stop"],
          f"instances alive after stop: {res['alive_after_stop']}")
    return res


def _cli_demo(ce):
    """(c) ``v6t-torch dev``: a store, a server and 3 nodes as detached
    processes; ``central_average`` over ``age`` as ``dev_admin`` and the
    demo store's algorithms through the server's ``/api/store/*``
    proxy."""
    import socket

    import pandas as pd

    from vantage6_tpu_torch.client import UserClient

    for port in CLI["demo_ports"]:
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                check(False, f"the demo network's port {port} is taken")
    n = CLI["demo_nodes"]
    t0 = time.perf_counter()
    ce.cli("dev", "create-demo-network", "-n", str(n))
    create_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, _ = ce.cli("dev", "start-demo-network")
    ce.started(out)
    url = f"http://127.0.0.1:{CLI['demo_ports'][0]}"
    c = UserClient(url)
    c.authenticate("dev_admin", "password123")
    _wait_online(c, n, CLI["start_timeout"])
    up_s = time.perf_counter() - t0
    collab = next(x for x in c.collaboration.list() if x["name"] == "demo")
    org0 = next(x for x in c.organization.list()
                if x["name"] == "demo_org_0")
    t0 = time.perf_counter()
    t = c.task.create(collaboration=collab["id"], organizations=[org0["id"]],
                      image="v6-average-py",
                      input_={"method": "central_average",
                              "kwargs": {"column": "age"}})
    (out_avg,) = c.wait_for_results(t["id"], interval=0.01, timeout=300)
    task_ms = 1e3 * (time.perf_counter() - t0)
    csvs = sorted(os.path.join(root, f) for root, _, fs
                  in os.walk(ce.env["XDG_DATA_HOME"])
                  for f in fs if re.fullmatch(r"demo_org_\d+\.csv", f))
    age = np.concatenate([pd.read_csv(p)["age"].to_numpy(np.float64)
                          for p in csvs])
    rel = abs(out_avg["average"] - age.mean()) / abs(age.mean())
    algos = c.request("GET", "store/algorithm")["data"]
    approved = sorted(a["image"] for a in algos if a["status"] == "approved")
    ce.cli("dev", "stop-demo-network")
    demo = {k: v for k, v in ce.pids.items()
            if k in ("store", "server") or k.startswith("node demo_")}
    alive = {k: v for k, v in ce.alive().items() if k in demo}
    ce.cli("dev", "remove-demo-network")
    res = dict(create_s=create_s, up_s=up_s, task_ms=task_ms,
               average=out_avg, numpy=float(age.mean()), rel_err=rel,
               csvs=len(csvs), store_algorithms=approved,
               instances=sorted(demo), alive_after_stop=alive)
    print(f"demo network: created in {create_s:.1f} s, {n} nodes + server "
          f"+ store up in {up_s:.1f} s; central_average {task_ms:.1f} ms "
          f"{out_avg} vs numpy {age.mean()!r} (rel {rel:.3e}) over "
          f"{len(csvs)} CSVs; {len(approved)} approved algorithms through "
          f"/api/store; alive after stop {alive}")
    check(len(demo) == n + 2, f"demo instances started: {sorted(demo)}")
    check(len(csvs) == n and out_avg["count"] == age.size
          and rel <= FANOUT_NUMPY_RTOL,
          f"the demo average is off numpy's: {out_avg} vs {age.mean()!r}")
    check(len(approved) == 8, f"the demo store lists {approved}")
    check(not alive, f"demo instances alive after stop: {alive}")
    return res


def _cli_tools(ce):
    """(d) ``v6t-torch test`` and an ``algorithm create`` package whose
    generated test passes under the port's ``MockAlgorithmClient``."""
    out, test_s = ce.cli("test")
    (line,) = [ln for ln in out.splitlines() if "smoke OK" in ln]
    ce.cli("algorithm", "create", "--name", "p17-avg", "--directory", ce.tmp)
    proc, out, pytest_s = ce.python(
        "-m", "pytest", "-q", "-p", "no:cacheprovider",
        os.path.join(ce.tmp, "p17_avg", "test_algorithm.py"), cwd=ce.tmp,
        timeout=300)
    res = dict(test=line, test_s=test_s, generated_test_rc=proc.returncode,
               generated_test_s=pytest_s)
    print(f"v6t-torch test: {line} ({test_s:.1f} s); algorithm create's "
          f"generated test exited {proc.returncode} ({pytest_s:.1f} s)")
    check(proc.returncode == 0,
          f"the generated algorithm test failed: {out[-2000:]}")
    return res


def phase_cli(fa, torch, dev):
    """Phase 17 (module doc): the CLI on the card."""
    import shutil
    import tempfile

    missing = [name for name, ok in optional_packages().items()
               if name in ("click", "yaml") and not ok]
    if missing:
        print(f"phase 17 (the CLI on the card) not run: "
              f"{' and '.join(missing)} do(es) not import here")
        return {"not_run": missing,
                "launches": dict.fromkeys(fa.KERNELS, None)}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="v6t-cli-")
    ce = _CliEnv(tmp)
    try:
        res = {"run": _cli_run(torch, dev, ce),
               "node": _cli_node(torch, dev, ce),
               "demo": _cli_demo(ce),
               "tools": _cli_tools(ce)}
        res["jax_imported"] = os.path.exists(ce.marker)
        launches, uncounted = ce.launches(fa.KERNELS)
        res["children_counted"] = len(os.listdir(ce.counts))
    finally:
        ce.close()
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    res["launches"] = launches
    print(f"CLI flash launches: {launches} over the "
          f"{res['children_counted']} Python processes the phase's commands "
          f"ran (0 expected: FedAvg-CNN and the device engine's eager "
          f"programs); jax imported by a child {res['jax_imported']}; phase "
          f"{res['seconds']:.1f} s")
    check(not uncounted, f"children that wrote no launch count: {uncounted}")
    check(not res["jax_imported"], "a child of phase 17 imported jax")
    check(sum(launches.values()) == 0,
          f"phase 17 launched a flash kernel: {launches}")
    return res


def kernel_rows(fa, times, flash_runs, other_launches):
    """The ``kernels`` line: each forward kernel at each dtype and width it
    was timed at, and the backward kernel at each shape of BWD_TIMED
    (``times`` from ``phase_times``). ``launches`` are those of the flash
    runs (``flash_runs``) in that dtype at that head dim, and
    ``launches_<phase>`` the other phases' counts of a forward variant
    (``other_launches``: {phase: {variant: count}}). Fails unless each
    flash run's forward kernel, and its backward kernel where the kernel
    served its backward, has a row whose launches are that run's, above
    0."""
    from vantage6_tpu_torch.ops import _build

    kernels = []
    for case, name, _, hd, variants in TIMED:
        for variant in variants:
            spec = fa.KERNELS[variant]
            short = {"bfloat16": "bf16", "float32": "f32"}[name]
            kernels.append(dict(
                name=f"{spec.symbol.removeprefix('v6t_')}_{short}_d{hd}",
                variant=variant, route="cuda",
                source="vantage6_tpu_torch/ops/csrc/"
                       + _build.SOURCES[spec.library],
                replaces="vantage6_tpu/ops/flash_attention.py:31",
                launches=sum(r["launches"][variant] for r in flash_runs
                             if r["head_dim"] == hd
                             and r["config"]["dtype"] == name),
                **{f"launches_{phase}": counts[variant]
                   for phase, counts in other_launches.items()},
                **{key: times[case][variant][key] for key in (
                    "dtype", "shape", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "bound_term", "library_ms",
                    "library_backend")},
            ))
    bwd = fa.BACKWARD_KERNEL
    for case, _, _, _, hd in BWD_TIMED:
        kernels.append(dict(
            name=f"{bwd.symbol.removeprefix('v6t_')}_bf16_{case}",
            variant="backward", route="cuda",
            source="vantage6_tpu_torch/ops/csrc/"
                   + _build.SOURCES[bwd.library],
            replaces=None,  # the JAX package's backward is jnp
            launches=sum(r["backward_launches"]["kernel"] for r in flash_runs
                         if r["head_dim"] == hd
                         and r["config"]["dtype"] == "bfloat16"),
            **{key: times[case]["backward"][key] for key in (
                "dtype", "shape", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "bound_term", "library_ms",
                "library_backend")},
        ))
    for r in flash_runs:  # each main path's kernels: a row, and launches
        check(any(kr["variant"] == r["variant"]
                  and kr["dtype"] == r["config"]["dtype"]
                  and kr["shape"].endswith(f",{r['head_dim']}]")
                  and kr["launches"] == r["launches"][r["variant"]] > 0
                  for kr in kernels),
              f"the {r['variant']} kernel at D = {r['head_dim']} has no row "
              "or launched no time on its main path")
        n_bwd = r["backward_launches"]["kernel"]
        check(n_bwd == 0 or any(
                  kr["variant"] == "backward"
                  and kr["dtype"] == r["config"]["dtype"]
                  and kr["shape"].endswith(f",{r['head_dim']}]")
                  and kr["launches"] == n_bwd for kr in kernels),
              f"the backward kernel at D = {r['head_dim']} has no row for "
              f"its {n_bwd} launches on its main path")
    return kernels


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
            fn = re.search(
                r"Function properties for \S*?(flash_(?:fwd|bwd)_\w+?E)",
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
    # 4 (c): the flash round at a head dim that runs a padded width
    phi3, eng_state = phase_slice(fa, ft, torch, dev, torch.bfloat16,
                                  shape=PHI3, rounds=PHI3_ROUNDS,
                                  must_fall=False, label="phi3-mini bf16")
    del eng_state
    # 4 (d): a head dim above 256, the kernel's O slabs over depth chunks
    wide, eng_state = phase_slice(fa, ft, torch, dev, torch.bfloat16,
                                  shape=WIDE, rounds=WIDE_ROUNDS,
                                  must_fall=False, label="d512 bf16")
    del eng_state
    for name, r in [*slice_res.items(), ("phi3-mini bfloat16", phi3),
                    ("d512 bfloat16", wide)]:
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
    cli = phase_cli(fa, torch, dev)
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
          + f"; fan-out over {cf['stations']} daemons quiet "
          f"{cf['quiet']['ms']:.1f} ms, loaded {cf['loaded']['ms']:.1f} ms "
          f"with {cf['loaded']['pushes']} pushes (Federation "
          f"{cf['federation_ms']:.1f}); sandboxed run "
          f"{control['sandbox']['wall_ms']:.1f} ms; phase "
          f"{control['seconds']:.1f} s on {card}")
    if "not_run" not in cli:
        print(f"cli: run {cli['run']['command_s']:.1f} s (in-process "
              f"{cli['run']['in_process_s']:.1f} s); node up "
              f"{cli['node']['up_s']:.1f} s, device engine "
              + ", ".join(f"{k} {v['rest_ms']:.1f} ms" for k, v in
                          cli["node"]["calls"].items())
              + f"; demo network up {cli['demo']['up_s']:.1f} s, "
              f"central_average {cli['demo']['task_ms']:.1f} ms; test "
              f"{cli['tools']['test_s']:.1f} s; phase "
              f"{cli['seconds']:.1f} s on {card}")

    flash_runs = [*slice_res.values(), phi3, wide]
    kernels = kernel_rows(fa, times, flash_runs, {
        "ring": {v: sum(r["launches"][v] for r in ring.values())
                 for v in fa.KERNELS},
        **{name: res["launches"] for name, res in (
            ("fedavg", fedavg), ("compression", compression),
            ("analysis", analysis), ("task_plane", task_plane),
            ("planes", planes), ("workloads", workloads),
            ("distributed", distributed), ("ops", ops), ("crypto", crypto),
            ("control_plane", control), ("cli", cli))},
    })
    result = dict(card=card, kind=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  max_abs_err_cases=max_err_cases, slice=slice_res,
                  slice_phi3=phi3, slice_d512=wide,
                  ring=ring, parallel_ops=parallel_ops, wire=wire,
                  fedavg=fedavg, compression=compression, analysis=analysis,
                  task_plane=task_plane, planes=planes,
                  workloads=workloads, distributed=distributed, ops=ops,
                  crypto=crypto, control_plane=control, cli=cli,
                  kernels=kernels,
                  times=times, profile=prof,
                  seconds=time.perf_counter() - t_start)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(json.dumps({"slice": slice_res, "slice_phi3": phi3,
                      "slice_d512": wide, "ring": ring,
                      "parallel_ops": parallel_ops, "wire": wire,
                      "fedavg": fedavg,
                      "compression": compression, "analysis": analysis,
                      "task_plane": task_plane, "planes": planes,
                      "workloads": workloads, "distributed": distributed,
                      "ops": ops, "crypto": crypto,
                      "control_plane": control, "cli": cli}, default=str))
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
