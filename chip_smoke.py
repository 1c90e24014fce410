#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ultra_pytorch_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Device: the card's name and power limit (nvidia-smi); TF32 off.
2. Build: K1-K5 (``ops/kernels/csrc/*.cu``), one nvcc per source, all
   started together, and ptxas's register / shared-memory / spill report;
   K1 and K2 must spill nothing and must hold tensor-core instructions
   (``HMMA``/``HGMMA`` in ``cuobjdump --dump-sass`` of their libraries).
3. Kernel parity, each kernel against its plain PyTorch version on the
   card: K1 at the full serving width (F = 136, hidden [512, 256, 128])
   at 32,768 rows (64-row tiles), 2,560 (a training step, 32-row tiles)
   and 1,000 (a ragged tile);
   K2 at N = 2,560 (a training step), 1,000 (a ragged tile) and 32,768
   (many blocks), bit-for-bit deterministic; K3/K4 at [256, 10] (one
   block), [1024, 200] and [16384, 10] (many blocks) and [64, 1300]
   (lists read in chunks) with masked lists and zero-denominator lists,
   K3's residual against its plain version, the same bits on a rerun, a
   stride-0 broadcast and column-sliced rows bit-identical to their
   contiguous copies; K5 exactly equal to its plain version, and its
   per-position click rates within 4 sigma of exam * click_prob.
4. Serving: a seeded full-width DNN written as a checkpoint, loaded by
   ``Scorer.from_checkpoint`` (auto mode, so K1 in one CUDA graph a
   bucket), served over HTTP through a ``MicroBatcher``; every reply
   checked against the plain version, and the K1 launch count of that
   run, counted through the replays, one a device call.
5. Serving timing: K1, plain version and a chain of library calls at the
   serving buckets and a training step's rows, as device time a call
   (CUDA graph replay) and back to back, with the least time the card
   could take at 3xTF32 (K1's products run so: the ``bound_ms`` of the
   kernels line) and at float32 on CUDA cores (``bound_f32_ms``); K1 held
   to the library chain; one ``Scorer`` call per bucket, with K1 and with
   the plain DNN path.
6. One DLA step at full width on a fixed batch, kernels on against the
   plain path: the losses and both towers' gradients.
7. Training at full width (the bench protocol of ``tools/bench_common.py``:
   DLA, DNN [512, 256, 128], F = 136, B = 256, L = 10, PBM clicks with
   compact resampling and the window plan, Adagrad): 4,096 synthetic
   queries from ``--seed``, 4 windows of 50 steps with all three kernel
   hparams on. The launch counts of that run must be K2 = steps,
   K3 = K4 = 2 x steps, K5 = windows + 1 (the feed's click-rate estimate);
   losses finite; a validation nDCG@10 after every window. The same run
   with the kernels off, in turns (on, off, off, on), for queries/s; then
   where a step's time goes (CUDA events per part, and torch.profiler).
8. The CLI end to end on a small ULTRA-format dataset written under
   ``build/``: ``python -m ultra_pytorch_tpu_torch.run`` trains with the
   kernels on and keeps the best checkpoint, ``--test_only`` writes a
   ranklist, and a ``Scorer`` loads that checkpoint and serves it.
9. Kernel timing at the training shapes: K2-K5, their plain versions and
   the library calls (K2: forward and backward of the library chain by
   autograd; K5: ``torch.bernoulli``), with the least time the card could
   take (K2 at 3xTF32, K3-K5 at float32 on CUDA cores). K3/K4 also at
   [16384, 10], beside the launch floor (a one-element ``zero_()``) and,
   for K3, ``F.cross_entropy`` on precomputed inputs as a yardstick.
10. The offline debiasing family (Naive, IPW, Regression-EM, PairDebias,
    LambdaRank, PRS), one step each on phase 6's batch, kernels on against
    the plain path (Regression-EM with the same uniforms): the loss within
    LOSS_TOL relative, the ranker gradient within GRAD_TOL of its largest.
11. The family's training: each algorithm 2 windows x 50 steps on phase
    7's data and protocol (``fused_softmax_loss`` for Naive and IPW; IPW
    and PRS read the reference's estimator JSON). Exact launch counts:
    K1 = steps (2 x steps for Regression-EM: its E-step's no-grad
    forward) + the validation batches, K2 = steps, K3 = K4 = steps for
    Naive and IPW and 0 for the others, K5 = windows + 1; losses finite,
    nDCG@10 in [0, 1], Regression-EM's propensity in [0, 1], t+ and t-
    finite and positive. The same run plain launches nothing. Queries/s
    both ways in turns (on, plain), and phase 7's step
    breakdown for PairDebias.
12. Propensity estimation: the randomized estimator at the reference's
    10M sessions over phase 7's train split (PBM, eta 1), every weight
    within 3% of exam[0] / exam[x], sessions/s; then the estimator CLI
    (``python -m ultra_pytorch_tpu_torch.sim.propensity``) on phase 8's
    data.
13. IPWrank through the training CLI on the JSON the estimator CLI wrote,
    ``--test_only`` and a ``Scorer`` on its checkpoint; Regression-EM and
    PairDebias ``Experiment`` checkpoints restored bit for bit, aux state
    included.
14. Rankers and click models: the six configs that the Linear, SetRank,
    DLCM and GSF rankers and the UBM and cascade click models bring
    (``dla_ubm``, ``naive_cascade`` with the DNN at [512, 256, 128];
    ``dla_setrank``, ``dla_dlcm``, ``naive_gsf``, ``naive_linear`` at the
    JAX package's default hparams; PBM, UBM and cascade from
    ``example/ClickModel/``), all at F = 136, B = 256, L = 10 on phase
    7's data with every kernel hparam their paths allow. UBM and cascade
    clicks on the card equal the CPU's given the same uniforms (cascade
    at most one a list); one step each kernels on against plain (phase
    10's tolerances); 2 windows x 50 steps each with exact launch counts
    (the DNN configs K1 = steps + the validation batches and K2 = steps;
    K3 = K4 = 2 x steps for DLA, steps for Naive; K5 = windows + 1 for
    PBM, 0 for UBM and cascade; the same run plain launches nothing),
    queries/s in turns (on, plain), phase 7's step breakdown
    for ``dla_setrank`` and ``dla_dlcm`` kernels on and plain, each
    kernels-on run's checkpoint loaded by ``Scorer.from_checkpoint`` and
    served over HTTP
    through a ``MicroBatcher`` (every reply equal to direct scoring);
    SetRank at ``rate=0.1`` for 50 steps (finite losses, eval scores
    unchanged by a second call); and ``dla_ubm`` and ``naive_cascade``
    with ``use_pallas_click=true`` and ``use_pallas=true``, which the JAX
    feed runs (its kernel branch is PBM's alone): one window each, K5
    launched 0 times and the other kernels exactly, the window plan's
    clicks under one generator equal to the same config's without the
    flag.
15. Kernels, after phase 24: one JSON line listing K1-K5 (launches
    summed over the serving, DLA training, offline training, phase 14's,
    phase 16's, phase 17's, both ranks' of phase 18's, phases 19's and
    20's graph and CLI runs, phase 21's convergence runs, phase 22's
    data-parallel graph windows and replayed serving buckets, the
    tools' runs of phase 23, every rank's of phase 24 and the bench
    scripts' of phase 25; K1-K4 also with their timing at the demo's
    shapes under "demo" and with the cutoff at L under "demo_off_path",
    K1/K2 at bench_exp's Yahoo-like shape under "bench_exp"), then the
    result line.
16. The online family: the six configs ``naive_online``, ``pdgd``,
    ``dbgd``, ``dbgd_ndcg``, ``mgd`` and ``nsgd`` (each config's own
    file with the DNN at [512, 256, 128], every kernel hparam its path
    allows, L = 10) on Lc = 120 candidates a query, MSLR-WEB10K's mean
    list length: the online feeds score and rank the whole list every
    step. The draft on the card equals the CPU's given the same order;
    the DBGD noise has unit columns; NSGD's null-space samples keep
    their properties on the card, and its null basis of a memory of each
    rank 0-4 at the first layer's size: e_0 ... e_3 at rank 0, 4 - rank
    orthonormal rows orthogonal to the memory. One step of each config
    kernels on against
    plain on a fixed batch (the DBGD family with the same noises and
    winners: candidate scores within TOL, the parameter delta within
    GRAD_TOL; Naive and PDGD: phase 10's tolerances). Then each 2
    windows x 50 steps on 4,096 synthetic queries of 120 candidates in
    turns (on, plain; two turns, not four, to make room for phase 20),
    through graph windows: exact launch
    counts (K1 = 2, 3, 3, 3, 6, 6 a step + the validation batches; K2 =
    steps for Naive and PDGD; K3 = K4 = steps for Naive; K5 none; plain
    launches nothing), losses and online metrics finite, nDCG@10 in [0,
    1]; phase 7's eager step breakdown for MGD and NSGD (feed, noise with
    NSGD's null bases, candidates, winners, update); NSGD's checkpoint
    served over HTTP; the CLI with ``--test_only`` for PDGD and NSGD on
    phase 8's data.
17. Data formats: libsvm data at MSLR-WEB10K's shape (F = 136, grades
    0-4, 120 documents a query; 1,024 train queries, about 180 MB of
    text, 256 valid and 256 test) written from ``--seed`` with vectorised
    formatting, and its ULTRE twin (did-keyed ``.feature``, ``qid did
    ...`` lists, a click-model directory of logged clicks for train).
    The native parser (built with g++ from the port's copy) reads the
    libsvm train split: features, grades, qids and dids exactly as
    written; rows/s and MB/s. The ULTRE loader takes the click-model
    directory's labels. DLA with the DNN at full width and every kernel
    on trains through the CLI (in this process, so its launches count):
    2 x 50 steps on libsvm, 1 x 50 on ULTRE, then ``--test_only`` writes
    the ranklist; exact launch counts (K1 once a step and once a
    validation batch, K2 once a step, K3 = K4 twice, K5 once a window
    plus one).
18. Data parallelism on one card: two gloo ranks share cuda:0 (spawned;
    the kernels were built in phase 2). DLA at full width, B = 256 (128 a
    rank), every kernel on, 2 x 50 steps on phase 8's data: the state
    bit-identical on both ranks after each window (rank 0's broadcast),
    equal window metrics, exact launch counts on each rank, rank 0 alone
    writes the checkpoint and one process's ``--test_only`` restores it.
    One step on the two halves of phase 6's batch equals one process's
    step on the mean of the two shards' gradients (loss within LOSS_TOL
    relative, update within GRAD_TOL of its largest; ``sgd`` with a clip
    that binds). One window each of Regression-EM, PairDebias and MGD
    (Lc = 120, R = 4) with the state, aux included, bit-identical across
    ranks; ``--shard_data`` keeps exactly each rank's stripe. Printed,
    not judged: the gloo all-reduce of the flat gradient, and queries/s of
    one rank alone against two summed, in turns (1, 2, 2, 1). Then NCCL at
    world size 1: the backend resolves to NCCL, torch.profiler records its
    kernel, and a DLA window equals the window without a group.
19. Fused windows: each of the 14 offline configs of ``configs/`` (every
    kernel hparam its path allows) on phase 7's data and protocol, two
    eager windows of 50 steps against two replayed CUDA graph windows
    from the same state and data key: the state (ranker, optimizer
    vector, aux), the data key and the window metrics bit for bit (or
    within CAPTURE_TOL where CAPTURE_DIFFERS names the library op), the
    graph's launches exact through the replays (phases 7's, 11's and
    14's per-step formulas), and the graph validation pass equal to the
    eager one, also at 30,720 rows a batch (phase 17's shape). Queries/s
    of window 2 in turns (graph, eager, eager, graph, then the plain path
    graph and eager) for DLA, PairDebias, ``dla_setrank`` and
    ``dla_dlcm``, with torch.profiler's busy and idle share of a graph
    window; then DLA through the CLI on phase 8's data, pipelined and
    with ``--sync_readback`` (2 windows and a tail): the same lines, the
    same checkpoint, exact launches. Every other phase's training now
    runs through the same graphs (phases 7, 11, 14, 16 and 17; the ranks
    of phase 18 run eager), and their step breakdowns time the eager
    window.
20. The online family's fused windows: each of phase 16's six configs at
    its shapes (Lc = 120), 2 x 50 steps in turns graph, eager from the
    same seed (two turns, not four, to make room for phase 25): the
    graph run equal to the eager run bit for bit (state, optimizer
    vector, NSGD's memory, data key, window metrics), every run's
    launches exact (phase 16's per-step formulas; the graph's through its
    replays), queries/s of window 2; for MGD and
    NSGD the eager and the graph window's ms a step, torch.profiler's busy
    ms and idle share and the device-to-host copies in a window (a
    replayed window may make one, its metrics' read-back). Then
    ``naive_online`` with eta growing 0.5 every 30 steps: two graph
    windows equal to two eager ones across the intervals and unlike the
    fixed-eta run; and PDGD and NSGD at full width through the CLI on
    phase 8's data, pipelined and with ``--sync_readback`` (2 windows and
    a tail): the same lines, the same checkpoint (NSGD's memory
    included), exact launches.
21. The offline experiment pipeline and the convergence study. (a)
    ``example/torch_dataset_pipeline.sh`` at ``DEVICE=cuda`` on libsvm data
    from ``torch_convergence.py``'s generator (512 train queries, 128 valid,
    128 test): clean, normalize, sample, the port's initial ranker on the
    card, ULTRA prep, DLA with every kernel on for 2 windows through the
    CLI as CUDA graphs, ``--test_only``; the ranker's ``model.npz``, one
    finite score a row in each ``.predict`` file and one TREC line a test
    document checked; the ranker's Adagrad step on fixed pairs on the card
    within 1e-6 of the CPU's. (b) The convergence study at its full
    protocol (``torch_convergence.py``: DLA, IPWrank, RegressionEM,
    PairDebias, NaiveAlgorithm, PDGD and MGD, 5 seeds each, the DNN at
    [512, 256, 128] with every kernel hparam its path allows, graph
    windows) against ``tests/torch_convergence_expected.json``: the
    generated files' sha256s equal the fixture's, the study's launches
    exact, one line a run with its wall time and one an algorithm (mean
    and standard deviation of peak and final nDCG@10 on both sides, the
    band, the verdict); an algorithm outside its band fails the run.
22. The data-parallel window and the serving bucket as CUDA graphs.
    [dp graph] As a rank of an NCCL group of one on cuda:0: DLA (K1-K5),
    Regression-EM, PairDebias (phase 7's data), PDGD, MGD and NSGD (phase
    16's, Lc = 120), each two data-parallel windows of 50 steps replayed
    as graphs (``eager_reason()`` None, the all-reduces inside) against
    two eager ones (``fuse_window=False``): state, optimizer, aux, data
    key and window metrics bit for bit, launches exact both ways; DLA's
    also equal to its graph windows without a group. torch.profiler sees
    NCCL's kernel inside a replayed DLA window; DLA's queries/s of window
    2 in turns (graph, eager, eager, graph, the graph without a group
    first and last) and the busy and idle share of each way's window.
    Then whether NCCL takes two ranks on cuda:0, printed as a line.
    [serve graph] Each ranker from a checkpoint its Experiment wrote
    (phase 14's configs, weights from the seed): ``warmup`` captures
    every bucket up to 256x128; each bucket and a 1,000-document list,
    graph replay against the eager body (``graphs=False``): scores within
    TOL, orders equal; five requests that shrink inside one bucket
    against a freshly zero-padded bucket (stale padding would show). The
    DNN's ``Scorer`` call at 8x16, 256x16 and 256x128, graph against
    eager body in turns, K1's device time inside a replay, and K1
    counted once a replayed call; this part runs in a child process
    (``python3 chip_smoke.py --serve-replays dla_ubm``) on the DNN's
    checkpoint, because late in one long process torch.profiler keeps
    only about one replay's device records of five, and in a fresh one
    it keeps them all.
23. The tools (``ultra_pytorch_tpu_torch/tools/``) on the card, each
    through its ``main(argv)`` (what ``python -m`` runs), all in one
    child process, with its default device (the card) at a short length,
    its last line read as JSON and its launches added to the kernels
    line; ``profile_step``, ``roofline`` and ``bench_eval`` at the JAX
    tool's default (the kernel hparams off: the library path, launching
    K1-K5 0 times) and with ``--kernels`` (launching exactly
    ``dla_launches`` of their steps and windows), both ways' step time,
    busy share and ``mfu`` on one line: ``profile_step`` (feed, train
    and full a step all above 0, each graph below its eager twin),
    ``roofline`` (``mfu`` in (0, 1], the same ``flops_per_step`` both
    ways, ``hfu`` null on the library path, the kernels' count equal to
    ``mlp_work`` + ``mlp_bwd_work`` + twice ``loss_work``'s K3 and K4,
    the products 3.59 GFLOP a step within 2%),
    ``bench_serve`` (K1's scores within TOL of the plain path's and its
    orders a ranking of the plain scores up to 2 x TOL at every bucket),
    ``bench_serve_http`` (no error on either row, a coalescing factor
    above 1 on the micro-batched one) and ``bench_eval`` (the graph pass,
    the per-batch loop and both pipelines within 1e-4).
24. The JAX system's multi-device entry points (``__graft_entry__.py``,
    ``tools/bench_scaling.py``, ``tools/shard_data_demo.py``) through the
    port: (a) ``run/dryrun.entry()``, one K1 launch over [8, 10, 136]
    within TOL of its plain version; (b) ``dryrun_multichip``'s 18 cases
    as an NCCL group of one (every window a graph) and as two gloo ranks
    sharing cuda:0, each case at step 2 with a finite loss and the state
    bit-identical across ranks; (c) ``bench_scaling 25 4`` at the JAX
    default (the library path, no launch), then with ``--kernels`` over
    the visible cards and with ``--share_card 2``, each row's launches
    exact and its ranks' state identical; (d) ``shard_data_demo
    --kernels`` at its full default size (10M rows x 220 features, lists
    of 200) as two stripes on cuda:0 and as the whole table on one rank,
    then at the JAX default on 2M rows: finite losses, each rank's share
    of the table, exact launches (none at the default); (e) one DLA step on a
    batch of B = 256 lists of L = 200 documents of F = 220 features,
    kernels on against plain (phase 6's tolerances), first at the
    demo's own settings (cutoff 10: K1 and K2 over the 2,560 x 220 rows
    the demo's steps run, K3 and K4 at [256, 10]), then with the cutoff
    at L (51,200 x 220 rows, [256, 200]: no path of the slice runs it);
    K1-K4 timed at both (the comparisons' launches are not counted).
25. The JAX system's benchmark scripts (``bench.py``,
    ``tools/bench_exp.py``, ``tools/bench_pallas.py``'s part 3) through
    the port, each through its ``main(argv)`` (what ``python -m`` runs),
    all in one child process, with its default device (the card), on
    JAX's protocol (``bench_common.make_bench_setup``:
    JAX's synthetic data and settings, the kernel hparams off unless an
    extra turns one on): (a) ``bench`` at its defaults, 2,400 steps in
    800-step graph windows after one warm-up window: its last line has
    exactly the JAX script's four keys and metric name, a finite
    ``value`` and ``vs_baseline`` above 0 (against this machine's CPU,
    measured in the run), K1-K5 launched 0 times, a finite loss, and the
    800-step window's graph pool under twice the peak memory of the same
    window run eager (from (e)); (b)
    ``bench --kernels`` launches exactly ``dla_launches`` for its steps
    and windows; (c) ``bench_kernels``' seven combinations, each
    launching exactly what its hparams select, every rate above 0; (d)
    ``bench_exp --features 700 --list-size 30`` without and with
    ``--ranker-extra ,use_pallas=true`` (launches exact), one DLA step
    there with K1/K2 against plain (phase 6's tolerances) and K1/K2 timed
    at its 7,680 x 700 rows; (e) in this process, the protocol's 50- and
    800-step graph windows against the same windows run eager: state,
    optimizer, aux, data key and metrics bit for bit, each graph's pool
    and each eager window's peak memory.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

# The bench protocol (F = 136, the DNN at [512, 256, 128], B = 256 x L =
# 10), its data and settings, the card's line and the H100's peaks, and
# the work counts behind each kernel's bound: the port's tools share them.
from ultra_pytorch_tpu_torch.tools.bench_common import (
    BATCH, FEATURES, HIDDEN, LIST, PEAK_3XTF32, PEAK_BF16, PEAK_BYTES,
    PEAK_F32, PEAK_TF32, card_line, device_events, dla_launches,
    dla_settings, synthetic, write_click_model, write_ultra_split)
from ultra_pytorch_tpu_torch.tools.roofline import (loss_work, mlp_bwd_work,
                                                    mlp_work)

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
BUCKETS = ((8, 16), (256, 16), (256, 128))   # (queries, docs) per call
WINDOWS, WINDOW = 4, 50        # training windows x steps
# K1 against its plain version: the same float32 arithmetic, but each
# dot product over K <= 512 is summed in another order (per thread in the
# kernel, blocked in cuBLAS), so results differ by a few ulps per layer.
TOL = 2e-4
# K2 and the DLA gradients: sums over rows in another order (per 16-row
# tile, then over tiles, in K2), held relative to the largest magnitude.
GRAD_TOL = 2e-4
# K3/K4: sums over a list and over the batch in another order.
LOSS_TOL = 1e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def seeded_dnn(hparams: str, gen: torch.Generator, device):
    """A DNN with torch-default init on `gen` and a non-trivial LayerNorm
    affine (as after training), on `device`."""
    from ultra_pytorch_tpu_torch.models.dnn import DNN

    model = DNN(hparams, FEATURES, generator=gen)
    with torch.no_grad():
        for layer in model.layers:
            n = layer.norm.weight.shape[0]
            layer.norm.weight.add_(0.1 * torch.randn(n, generator=gen))
            layer.norm.bias.add_(0.1 * torch.randn(n, generator=gen))
    return model.to(device)


def bound(ops: float, nbytes: float, peak_ops: float = PEAK_F32):
    """The least time in ms the card could take, and what bounds it."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA
    events, after a warm-up). Inputs stay in L2 between calls, as they do
    in a loop that calls the kernel step after step."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Device time of one call of `fn`: `calls` calls captured in a CUDA
    graph, and the graph replayed under CUDA events. A replay runs the
    kernels back to back, so unlike ``time_ms`` this leaves out the card's
    waits for the host's next launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture, as required
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def max_rel_err(got, ref):
    """(max abs error, max abs error over the reference's largest
    magnitude)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-12)


def library_chain(model, x):
    """The same function as library calls (F.layer_norm's two-pass
    variance, F.linear, F.elu): the yardstick, never called by the port."""
    h = x
    for j, layer in enumerate(model.layers):
        h = F.layer_norm(h, (h.shape[-1],), layer.norm.weight,
                         layer.norm.bias, eps=1e-5)
        h = F.linear(h, layer.linear.weight, layer.linear.bias)
        if j != len(model.layers) - 1:
            h = F.elu(h)
    return h[:, 0]


def counters():
    """The five kernels' launch counters as (holder, attribute name)."""
    from ultra_pytorch_tpu_torch.ops.kernels import click_sim, listwise_loss
    from ultra_pytorch_tpu_torch.ops.kernels import mlp

    return {"K1": mlp.fused_mlp_score, "K2": mlp.mlp_backward,
            "K3": listwise_loss.listwise_loss_forward,
            "K4": listwise_loss.listwise_loss_backward,
            "K5": click_sim.pbm_clicks}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def phase_device():
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)


def tensor_core_instructions(lib_path) -> int:
    """Tensor-core instructions (``HMMA``, ``HGMMA``) in a library's SASS,
    from ``cuobjdump --dump-sass`` beside the nvcc that built it."""
    from ultra_pytorch_tpu_torch.ops.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    proc = subprocess.run([cuobjdump, "--dump-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr[-500:]}")
    return sum(1 for line in proc.stdout.splitlines()
               if " HMMA." in line or " HGMMA." in line)


def phase_build():
    from ultra_pytorch_tpu_torch.ops.kernels import click_sim, listwise_loss
    from ultra_pytorch_tpu_torch.ops.kernels import mlp

    builds = {"K1": mlp.build_kernel, "K2": mlp.build_backward_kernel,
              "K3/K4": listwise_loss.build_kernel,
              "K5": click_sim.build_kernel}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(fn) for name, fn in builds.items()}
        built = {name: f.result() for name, f in futures.items()}
    print(f"[build] {len(built)} libraries in "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    for name, lib in built.items():
        print(f"[build] {name} {lib.path.name}: nvcc {lib.seconds:.2f} s",
              flush=True)
        for line in lib.log.splitlines():
            if any(w in line for w in ("Compiling", "registers", "spill",
                                       "smem")):
                print(f"[build] {name} ptxas: {line.strip()}", flush=True)
    for name in ("K1", "K2"):
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill",
                                             built[name].log)]
        check(spills and not any(spills), f"{name} spills registers")
        count = tensor_core_instructions(built[name].path)
        print(f"[build] {name}: {count} tensor-core instructions "
              "(HMMA/HGMMA) in its SASS; no spills", flush=True)
        check(count > 0, f"{name} has no tensor-core instruction")


def phase_parity(mlp, gen, dev):
    """K1 against its plain version; then K2 against autograd of it."""
    cases = (("elu/norm", HIDDEN, 32768), ("elu/norm ragged", HIDDEN, 1000),
             ("elu/norm training step", HIDDEN, BATCH * LIST),
             ("relu/no-norm", HIDDEN + ",activation_func=relu,norm=none",
              32768))
    worst = 0.0
    for name, hp, n in cases:
        model = seeded_dnn(hp, gen, dev)
        act, use_norm = model.hparams.activation_func, \
            model.hparams.norm == "layer"
        x = torch.randn(n, FEATURES, generator=gen).to(dev)
        with torch.inference_mode():
            got = mlp.fused_mlp_score(model.layers, x, act, use_norm)
            ref = mlp.fused_mlp_score_reference(model.layers, x, act,
                                                use_norm)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            rel = (err / ref.abs().clamp_min(1e-12)).max().item()
            worst = max(worst, err.max().item())
            print(f"[parity] K1 {name} N={n}: max abs {err.max().item():.3e} "
                  f"max rel {rel:.3e} (limit rtol=atol={TOL})", flush=True)
            check(got.shape == (n,) and bool(torch.isfinite(got).all()),
                  f"{name}: non-finite or misshapen scores")
            check(torch.allclose(got, ref, rtol=TOL, atol=TOL),
                  f"{name}: K1 disagrees with its plain version")
    return worst


def phase_k2_parity(mlp, gen, dev):
    """K2 against autograd of the plain forward, at a training step's rows,
    a ragged tile and many blocks; two runs must give the same bits.
    Activations with a continuous derivative (elu is the path's)."""
    cases = (("elu/norm", "elu", True, 2560),
             ("elu/norm ragged", "elu", True, 1000),
             ("elu/norm many blocks", "elu", True, 32768),
             ("tanh/no-norm", "tanh", False, 2560))
    worst = 0.0
    for name, act, use_norm, n in cases:
        model = seeded_dnn(HIDDEN, gen, dev)
        x = torch.randn(n, FEATURES, generator=gen).to(dev)
        g = torch.randn(n, generator=gen).to(dev)
        dx, grads = mlp.mlp_backward(model.layers, x, g, act, use_norm)
        again = mlp.mlp_backward(model.layers, x, g, act, use_norm)
        ref_dx, ref_grads = mlp.mlp_backward_reference(model.layers, x, g,
                                                       act, use_norm)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in
                  zip([dx] + grads, [again[0]] + again[1])),
              f"K2 {name}: two runs differ")
        abs_worst = rel_worst = 0.0
        for got, ref in zip([dx] + grads, [ref_dx] + ref_grads):
            check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                  f"K2 {name}: misshapen or non-finite gradient")
            err, rel = max_rel_err(got, ref)
            abs_worst, rel_worst = max(abs_worst, err), max(rel_worst, rel)
            check(rel <= GRAD_TOL, f"K2 {name}: gradient {tuple(ref.shape)} "
                  f"off by {rel:.3e} of its largest magnitude")
        worst = max(worst, abs_worst)
        print(f"[parity] K2 {name} N={n}: max abs {abs_worst:.3e}, max "
              f"{rel_worst:.3e} of the largest magnitude (limit "
              f"{GRAD_TOL}); deterministic", flush=True)
    return worst


def loss_inputs(batch, length, gen, dev):
    """s, y, w, m [B, L] with a fully masked list, a zero-denominator list
    and a half-masked one."""
    s = torch.randn(batch, length, generator=gen)
    y = (torch.rand(batch, length, generator=gen) < 0.3).float()
    w = torch.rand(batch, length, generator=gen) + 0.5
    m = (torch.rand(batch, length, generator=gen) < 0.9).float()
    m[0] = 0.0
    w[1] = 0.0
    y[2], m[2, length // 2:] = 0.0, 0.0
    return [t.to(dev) for t in (s, y, w, m)]


LOSS_SHAPES = ((BATCH, LIST), (1024, 200), (16384, 10), (64, 1300))


def phase_loss_parity(gen, dev):
    """K3/K4 against softmax_loss and its autograd gradient: one block
    ([256, 10]), many blocks ([1024, 200], [16384, 10]) and lists read in
    chunks ([64, 1300]); K3's residual against its plain version; the same
    bits on a rerun; a stride-0 broadcast and column slices equal to their
    contiguous copies; an all-masked batch is 0."""
    from ultra_pytorch_tpu_torch.ops import losses
    from ultra_pytorch_tpu_torch.ops.kernels import listwise_loss as ll

    worst = 0.0
    g = torch.tensor(2.5, device=dev)
    for batch, length in LOSS_SHAPES:
        s, y, w, m = loss_inputs(batch, length, gen, dev)
        sr = s.clone().requires_grad_(True)
        ref = losses.softmax_loss(sr, y, w, m)
        (ref_ds,) = torch.autograd.grad(2.5 * ref, sr)
        ref_stats = ll.listwise_loss_stats_reference(s, y, w, m)
        got, stats = ll.listwise_loss_forward(s, y, w, m, return_stats=True)
        ds = ll.listwise_loss_backward(s, y, w, m, g, stats)
        again, again_stats = ll.listwise_loss_forward(s, y, w, m,
                                                      return_stats=True)
        again_ds = ll.listwise_loss_backward(s, y, w, m, g, again_stats)
        torch.cuda.synchronize()
        loss_err = abs(got.item() - ref.item())
        ds_err, ds_rel = max_rel_err(ds, ref_ds)
        valid = m.sum(1) > 0   # a fully masked list's log_z is -1e9 + log L
        stat_rel = max(max_rel_err(stats.denom, ref_stats.denom)[1],
                       max_rel_err(stats.log_z[valid],
                                   ref_stats.log_z[valid])[1],
                       max_rel_err(stats.total, ref_stats.total)[1])
        worst = max(worst, loss_err, ds_err)
        geo = ll.launch_geometry(batch, length, ll.K3_THREADS)
        k4_geo = ll.launch_geometry(batch, length, ll.K4_THREADS)
        print(f"[parity] K3 [{batch}, {length}] ({geo.lanes} lanes a list, "
              f"{geo.chunks} chunk(s), {geo.blocks} block(s) of "
              f"{geo.threads}; K4 {k4_geo.blocks} of {k4_geo.threads}): loss {got.item():.6f} vs {ref.item():.6f} "
              f"(abs err {loss_err:.3e}); residual {stat_rel:.3e} of the "
              f"largest; K4: max abs {ds_err:.3e}, {ds_rel:.3e} of the "
              f"largest (limit {LOSS_TOL}); rerun bit-identical", flush=True)
        check(loss_err <= LOSS_TOL * abs(ref.item()) + 1e-6,
              f"K3 [{batch}, {length}] disagrees with softmax_loss")
        check(stat_rel <= LOSS_TOL, f"K3 [{batch}, {length}]: its residual "
              "disagrees with listwise_loss_stats_reference")
        check(ds_rel <= LOSS_TOL, f"K4 [{batch}, {length}] disagrees with "
              "the gradient of softmax_loss")
        check(not ds[0].any() and not ds[1].any(),
              "K4: a masked or zero-denominator list took a gradient")
        check(torch.equal(got, again) and torch.equal(ds, again_ds)
              and torch.equal(stats.buffer, again_stats.buffer),
              f"K3/K4 [{batch}, {length}]: a rerun gave other bits")
    zero = torch.zeros_like(s)
    loss, stats = ll.listwise_loss_forward(s, y, w, zero, return_stats=True)
    check(loss.item() == 0.0 and not ll.listwise_loss_backward(
        s, y, w, zero, torch.tensor(1.0, device=dev), stats).any(),
        "K3/K4: an all-masked batch is not 0")

    # DLA's propensity logits (one row broadcast with stride 0) and a
    # train_slice view (the first LIST columns of wider rows) go in as
    # they lie and give the bits of their contiguous copies.
    s, y, w, m = loss_inputs(BATCH, 2 * LIST, gen, dev)
    row = torch.randn(LIST, generator=gen).to(dev)
    cut = [t[:, :LIST] for t in (s, y, w, m)]
    for name, args in (("stride-0 scores", [row[None].expand(BATCH, LIST)]
                        + cut[1:]), ("column-sliced rows", cut)):
        dense = [a.contiguous() for a in args]
        got, stats = ll.listwise_loss_forward(*args, return_stats=True)
        want, want_stats = ll.listwise_loss_forward(*dense, return_stats=True)
        ds = ll.listwise_loss_backward(*args, g, stats)
        want_ds = ll.listwise_loss_backward(*dense, g, want_stats)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(ds, want_ds)
              and torch.equal(stats.buffer, want_stats.buffer),
              f"K3/K4 on {name} differ from their contiguous copy")
        print(f"[parity] K3/K4 {name} (strides {args[0].stride()}, "
              f"{args[1].stride()}): bit-identical to contiguous copies",
              flush=True)
    return worst


def phase_click_parity(dev):
    from ultra_pytorch_tpu_torch.ops.kernels import click_sim
    from ultra_pytorch_tpu_torch.sim.click_models import (
        click_probs, make_click_model)

    gen = torch.Generator(device=dev).manual_seed(5)
    for shape in ((1,), (7, 10), (WINDOW, 9 * BATCH, LIST)):
        probs = torch.rand(shape, generator=gen, device=dev)
        mask = (torch.rand(shape, generator=gen, device=dev) < 0.9).float()
        key = click_sim.draw_key(gen)
        got = click_sim.pbm_clicks(probs, mask, key)
        ref = click_sim.pbm_clicks_reference(probs, mask, key)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K5 {shape}: clicks differ from the "
              "plain version's")
        print(f"[parity] K5 {shape}: equal to the plain version "
              f"({int(got.sum().item())} clicks)", flush=True)
    model = make_click_model("pbm", 0.1, 1.0, 4, 1.0).to(dev)
    n = 400_000
    labels = torch.full((n, LIST), 4.0, device=dev)
    clicks = click_sim.sample_pbm_clicks(model, gen, labels)
    p = click_probs(model, labels[:1])[0]
    rate = clicks.mean(0)
    z = ((rate - p).abs() / (p * (1 - p) / n).sqrt()).max().item()
    print(f"[parity] K5 rates over {n} lists: max {z:.2f} sigma from "
          f"exam * click_prob (limit 4)", flush=True)
    check(z <= 4.0, "K5 click rates are off exam * click_prob")
    return 0.0


def phase_serving(mlp, gen, dev):
    from ultra_pytorch_tpu_torch.models.dnn import params_to_jax
    from ultra_pytorch_tpu_torch.serve import MicroBatcher, Scorer, \
        make_server
    from ultra_pytorch_tpu_torch.utils.checkpoint import save_checkpoint

    model_dir = os.path.join(WORK, "model")
    model = seeded_dnn(HIDDEN, gen, "cpu")
    save_checkpoint(os.path.join(model_dir, "DLA.ckpt"), params_to_jax(model),
                    metadata={"serve": {
                        "exp_settings": {
                            "ranking_model": "ultra.ranking_model.DNN",
                            "ranking_model_hparams": HIDDEN,
                            "learning_algorithm":
                                "ultra.learning_algorithm.DLA"},
                        "feature_size": FEATURES, "max_label": 4.0}})
    scorer = Scorer.from_checkpoint(model_dir)
    check(scorer.device.type == "cuda" and scorer.ranker.hparams.use_pallas,
          "auto mode did not select K1 on CUDA")

    rng = np.random.default_rng(0)
    requests = [[rng.normal(size=(rng.integers(10, 201), FEATURES))
                 .astype(np.float32) for _ in range(rng.integers(1, 17))]
                for _ in range(8)]
    requests.append([rng.normal(size=(1000, FEATURES)).astype(np.float32)])
    bodies = [json.dumps({"queries": [q.tolist() for q in qs]}).encode()
              for qs in requests]

    batcher = MicroBatcher(scorer)
    server = make_server(scorer, port=0, batcher=batcher)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d/v1/rank" % server.server_address

    def post(body):
        t0 = time.perf_counter()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return out, time.perf_counter() - t0

    try:
        reset_counts()
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies = list(pool.map(post, bodies))
        launches = mlp.fused_mlp_score.launches
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)

    worst = 0.0
    with torch.inference_mode():
        for qs, (out, _) in zip(requests, replies):
            check(len(out["ranked"]) == len(qs), "reply lost queries")
            for q, ranked, scores in zip(qs, out["ranked"], out["scores"]):
                n = len(q)
                check(sorted(ranked) == list(range(n)),
                      "ranked row is not a permutation")
                got = torch.tensor(scores, dtype=torch.float32)
                ref = mlp.fused_mlp_score_reference(
                    scorer.ranker.layers, torch.from_numpy(q).to(dev)).cpu()
                check(got.shape == (n,) and bool(torch.isfinite(got).all()),
                      "non-finite or misshapen scores")
                worst = max(worst, (got - ref).abs().max().item())
                check(torch.allclose(got, ref, rtol=TOL, atol=TOL),
                      "served scores disagree with the plain version")
                check(bool((got[ranked][1:] <= got[ranked][:-1]).all()),
                      "ranking is not by descending score")
    lat = sorted(dt for _, dt in replies)
    n_docs = sum(len(q) for qs in requests for q in qs)
    print(f"[serving] {len(requests)} requests, "
          f"{sum(len(qs) for qs in requests)} queries, {n_docs} docs; "
          f"{batcher.device_calls} device calls, {launches} K1 launches; "
          f"latency p50 {1e3 * lat[len(lat) // 2]:.1f} ms max "
          f"{1e3 * lat[-1]:.1f} ms; max abs err {worst:.3e}", flush=True)
    check(launches > 0, "the served requests never launched K1")
    check(launches == batcher.device_calls,
          "K1 launches != device calls (one launch per call expected)")
    return launches, model_dir


def scorer_ms(scorer, feats, iters: int = 20) -> float:
    """Host-clock time of one ``Scorer`` call (pad, copy in, score, mask,
    argsort, copy out); the copy out waits for the device."""
    for _ in range(3):
        scorer._score_ranked(feats, None)
    t0 = time.perf_counter()
    for _ in range(iters):
        scorer._score_ranked(feats, None)
    return 1e3 * (time.perf_counter() - t0) / iters


def phase_timing(mlp, gen, dev, model_dir):
    from ultra_pytorch_tpu_torch.serve import Scorer

    model = seeded_dnn(HIDDEN, gen, dev)
    layers = model.layers
    with_k1 = Scorer.from_checkpoint(model_dir)
    without = Scorer.from_checkpoint(model_dir, use_pallas=False)
    rng = np.random.default_rng(1)
    rows = {}
    with torch.inference_mode():
        # The serving buckets, a training step's rows and the online
        # path's full-list scoring (ONLINE_LIST candidates a query).
        for q, docs in BUCKETS + ((BATCH, LIST), (BATCH, ONLINE_LIST)):
            n = q * docs
            x = torch.randn(n, FEATURES, generator=gen).to(dev)
            calls = 50 if n <= 4096 else 10
            ms = graph_ms(lambda: mlp.fused_mlp_score(layers, x), calls)
            plain_ms = graph_ms(
                lambda: mlp.fused_mlp_score_reference(layers, x), calls)
            lib_ms = graph_ms(lambda: library_chain(model, x), calls)
            iters = 200 if n <= 4096 else 50
            call_ms = time_ms(lambda: mlp.fused_mlp_score(layers, x), iters)
            lib_call_ms = time_ms(lambda: library_chain(model, x), iters)
            lib_out = library_chain(model, x)
            k1_out = mlp.fused_mlp_score(layers, x)
            lib_diff = (lib_out - k1_out).abs().max().item()
            check(torch.allclose(k1_out, lib_out, rtol=TOL, atol=TOL),
                  f"K1 at {q}x{docs} disagrees with the library chain")
            ops, nbytes = mlp_work(model, n)
            # K1 multiplies as 3xTF32 on the tensor cores: its bound is at
            # that peak; the float32 CUDA-core bound is kept beside it.
            bound_ms, by = bound(ops, nbytes, PEAK_3XTF32)
            f32_ms = bound(ops, nbytes)[0]
            bounds = {name: bound(ops, nbytes, peak)[0]
                      for name, peak in (("tf32", PEAK_TF32),
                                         ("bf16", PEAK_BF16))}
            rows[(q, docs)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=bound_ms, bound_by=by,
                                   bound_f32_ms=f32_ms)
            tile = mlp._fwd_plan(mlp._widths(layers), n,
                                 mlp._sm_count(dev))[0]
            print(f"[timing] K1 {q}x{docs} ({n} rows, {tile}-row tiles): K1 "
                  f"{ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms (device time "
                  f"a call) | back to back: K1 {call_ms:.4f} ms, library "
                  f"{lib_call_ms:.4f} ms | {ops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.3f} MB | bound 3xtf32 {bound_ms:.4f} ms "
                  f"({by}, K1 at {100 * bound_ms / ms:.1f}%), f32 "
                  f"{f32_ms:.4f} ms ({100 * f32_ms / ms:.1f}%), tf32 "
                  f"{bounds['tf32']:.4f} ms, bf16 {bounds['bf16']:.4f} ms | "
                  f"{ops / ms / 1e9:.2f} TFLOP/s | library vs K1 max abs "
                  f"{lib_diff:.2e} (limit rtol=atol={TOL})", flush=True)
            if (q, docs) not in BUCKETS:
                continue
            feats = rng.normal(size=(q, docs, FEATURES)).astype(np.float32)
            k1_call, plain_call = scorer_ms(with_k1, feats), \
                scorer_ms(without, feats)
            print(f"[scorer] {q}x{docs}: Scorer call with K1 "
                  f"{k1_call:.3f} ms ({1e3 * q / k1_call:.0f} queries/s), "
                  f"plain DNN path {plain_call:.3f} ms "
                  f"({1e3 * q / plain_call:.0f} queries/s)", flush=True)
    return rows


def library_fwd_bwd(model, x, g):
    """K2's yardstick: the library chain's forward and its backward by
    autograd, for the same gradients K2 computes (it recomputes the
    forward too)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        params = list(model.parameters())
        out = library_chain(model, xr)
        return torch.autograd.grad(out, [xr] + params, g)


def fixed_batch(dev):
    """Phase 6's fixed training batch: B x L lists of F features, a quarter
    of them cut to 7 documents, clicks at 0.3 and always on the first."""
    rng = np.random.default_rng(3)
    mask = np.ones((BATCH, LIST), np.float32)
    mask[: BATCH // 4, 7:] = 0.0
    clicks = (rng.random((BATCH, LIST)) < 0.3).astype(np.float32) * mask
    clicks[:, 0] = 1.0
    return {"features": torch.from_numpy(rng.normal(
        size=(BATCH, LIST, FEATURES)).astype(np.float32)).to(dev),
        "labels": torch.from_numpy(clicks).to(dev),
        "mask": torch.from_numpy(mask).to(dev)}


def phase_dla_step(dev, click_json):
    """One DLA step at full width on a fixed batch: the kernels' losses and
    gradients against the plain path's, from the same initialisation."""
    from ultra_pytorch_tpu_torch.run.experiment import create_algorithm

    batch = fixed_batch(dev)
    out = {}
    for kernels in (True, False):
        settings = dla_settings(kernels, click_json)
        settings.update(max_candidate_num=LIST)
        alg = create_algorithm(settings, FEATURES, 2.0, dev)
        state = alg.init_state(torch.Generator().manual_seed(1))
        losses = alg.losses(state, batch)
        grads = torch.autograd.grad(losses[0], alg.trainable(state))
        n = len(state.params.jax_leaves())
        out[kernels] = ([t.item() for t in losses],
                        torch.cat([g.reshape(-1) for g in grads[:n]]),
                        torch.cat([g.reshape(-1) for g in grads[n:]]))
    (loss_k, rank_k, prop_k), (loss_p, rank_p, prop_p) = out[True], out[False]
    loss_err = max(abs(a - b) for a, b in zip(loss_k, loss_p))
    rank_err, rank_rel = max_rel_err(rank_k, rank_p)
    prop_err, prop_rel = max_rel_err(prop_k, prop_p)
    print(f"[dla step] kernels on vs plain: loss {loss_k[0]:.6f} vs "
          f"{loss_p[0]:.6f} (max abs err over loss, rank, exam "
          f"{loss_err:.3e}); ranker gradient max abs {rank_err:.3e} "
          f"({rank_rel:.3e} of its largest), propensity gradient "
          f"{prop_err:.3e} ({prop_rel:.3e}) (limit {GRAD_TOL})", flush=True)
    check(all(math.isfinite(v) for v in loss_k), "non-finite DLA loss")
    check(loss_err <= LOSS_TOL * abs(loss_p[0]) + 1e-6,
          "DLA losses differ between the kernels and the plain path")
    check(rank_rel <= GRAD_TOL and prop_rel <= GRAD_TOL,
          "DLA gradients differ between the kernels and the plain path")


def train_run(settings, dev, data, seed: int, windows: int = WINDOWS):
    """A full-width run of `windows` x WINDOW steps through the Experiment
    API; returns the per-window host seconds, mean metrics (the loss, and
    the online family's shown-list metrics) and validation summaries, and
    the experiment."""
    from ultra_pytorch_tpu_torch.run.experiment import Experiment

    exp = Experiment(settings, "unused", os.path.join(WORK, "train"),
                     batch_size=BATCH, seed=seed, device=dev)
    exp.setup(datasets=data)
    exp.init_state()
    seconds, metrics, summaries = [], [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(exp.train_steps(WINDOW))   # ends with a device read
        seconds.append(time.perf_counter() - t0)
        summaries.append(exp.validate("valid"))
    return seconds, metrics, summaries, exp


def phase_training(dev, click_json):
    data = {"train": synthetic(4096, 0), "valid": synthetic(1024, 1)}
    steps = WINDOWS * WINDOW
    # The main path: counts set to 0 before the Experiment is built (its
    # feed launches K5 once for the click-rate estimate) and read after.
    reset_counts()
    seconds, metrics, summaries, exp = train_run(
        dla_settings(True, click_json), dev, data, 0)
    counts = read_counts()
    losses = [m["loss"] for m in metrics]
    print(f"[training] kernels on: {steps} steps in {WINDOWS} windows; "
          f"pool {exp.feeds['train']._pool_size(BATCH)} candidates a step; "
          f"launches {counts}", flush=True)
    for w, (sec, loss, summ) in enumerate(zip(seconds, losses, summaries)):
        print(f"[training]   window {w + 1}: loss {loss:.5f}, "
              f"{WINDOW * BATCH / sec:.0f} queries/s, ndcg_10 "
              f"{summ['ndcg_10']:.5f} mrr_10 {summ['mrr_10']:.5f}",
              flush=True)
    check(all(math.isfinite(v) for v in losses), "non-finite training loss")
    check(all(math.isfinite(s["ndcg_10"]) and 0 <= s["ndcg_10"] <= 1
              for s in summaries), "validation nDCG@10 out of [0, 1]")
    want = {"K2": steps, "K3": 2 * steps, "K4": 2 * steps,
            "K5": WINDOWS + 1}
    for k, n in want.items():
        check(counts[k] == n, f"{k} launched {counts[k]} times on the "
              f"training path, expected {n}")
    check(counts["K1"] >= steps, "K1 launched fewer times than steps")

    # Queries/s in turns (on, off, off, on); the first window of each run
    # is its warm-up and is left out of the rate.
    rates = {True: [], False: []}
    rates[True].append(WINDOW * BATCH * (WINDOWS - 1) / sum(seconds[1:]))
    for kernels in (False, False, True):
        reset_counts()
        secs, run_metrics, _, _ = train_run(
            dla_settings(kernels, click_json), dev, data, 0)
        run_losses = [m["loss"] for m in run_metrics]
        if not kernels:
            check(not any(read_counts().values()),
                  "the plain path launched a kernel")
        check(all(math.isfinite(v) for v in run_losses),
              "non-finite training loss")
        rates[kernels].append(WINDOW * BATCH * (WINDOWS - 1) / sum(secs[1:]))
    print(f"[training] queries/s (host clock, windows 2-{WINDOWS}, turns "
          f"on/off/off/on): kernels on {rates[True]}, plain path "
          f"{rates[False]}", flush=True)
    step_breakdown(exp)
    return counts, exp.feeds["train"]._pool_size(BATCH), data


def step_breakdown(exp, tag: str = ""):
    """Where a step's time goes: CUDA events around each part of
    WINDOW steps (device time between the marks, which counts the device
    waiting on the host), the host's own time per part, then
    torch.profiler's device time per kernel over the same kind of steps.
    The optimizer part includes the aux state's update. `tag` names the
    algorithm in the printed lines."""
    feed, alg = exp.feeds["train"], exp.algorithm

    def window(record):
        m0 = mark()
        plan = feed.train_batch_plan(exp._window_generator(), exp.state.step,
                                     WINDOW)
        record("plan", m0, mark())
        for i in range(WINDOW):
            a = mark()
            batch = feed.batch_from_plan(plan, i)
            b = mark()
            out = alg.losses(exp.state, batch)
            c = mark()
            grads = torch.autograd.grad(out[0], alg.trainable(exp.state))
            d = mark()
            alg.update_aux(alg.apply_gradients(exp.state, grads), out)
            e = mark()
            for p, x, y in (("gather", a, b), ("forward+loss", b, c),
                            ("backward", c, d), ("optimizer", d, e)):
                record(p, x, y)

    step_wall = time_parts(f"[step{tag}]", ("plan", "gather", "forward+loss",
                                            "backward", "optimizer"), window)
    profile_steps(exp, f"[profile{tag}]", step_wall, fuse_window=False)


def mark():
    """A CUDA event recorded now, and the host clock."""
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e, time.perf_counter()


def time_parts(step_tag: str, parts, window) -> float:
    """Run ``window(record)`` (WINDOW steps; it calls ``record(part,
    mark_a, mark_b)`` around each part) once to warm up and once timed;
    print each part's device span and host time a step; return the wall
    seconds a step."""
    ev = {p: [] for p in parts}
    host = dict.fromkeys(parts, 0.0)

    def record(part, a, b):
        ev[part].append((a[0], b[0]))
        host[part] += b[1] - a[1]

    window(record)   # warm-up
    torch.cuda.synchronize()
    for p in parts:
        ev[p].clear()
        host[p] = 0.0
    t0 = time.perf_counter()
    window(record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev_ms = {p: sum(x.elapsed_time(y) for x, y in ev[p]) for p in parts}
    print(f"{step_tag} {WINDOW} steps in {1e3 * wall:.2f} ms wall "
          f"({1e3 * wall / WINDOW:.3f} ms a step)", flush=True)
    for p in parts:
        print(f"{step_tag}   {p}: device span {dev_ms[p] / WINDOW:.4f} ms "
              f"a step, host {1e3 * host[p] / WINDOW:.4f} ms a step",
              flush=True)
    return wall / WINDOW


def profile_steps(exp, prof_tag: str, step_wall: float,
                  fuse_window: bool):
    """torch.profiler's device time per kernel over WINDOW steps of
    ``exp`` (a replayed graph with `fuse_window`, else the eager window),
    against the unprofiled step's `step_wall` seconds, and the
    device-to-host copies in the window (the window's metrics come back in
    one). Returns (busy ms a step, idle share, device-to-host copies), or
    None when the profiler recorded no device activity."""
    timed = {}

    def profiled_window():
        t0 = time.perf_counter()
        exp.train_steps(WINDOW, fuse_window)   # ends with a device read
        timed["wall"] = time.perf_counter() - t0

    kernels = device_events(profiled_window)
    wall = timed["wall"]
    if not kernels:
        print(f"{prof_tag} torch.profiler recorded no device activity: the "
              "device busy share is not measured in this run", flush=True)
        return None
    by_name = {}
    for name, us in kernels:
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, count + 1)
    busy_ms = sum(us for _, us in kernels) / 1e3
    print(f"{prof_tag} {WINDOW} steps: wall {1e3 * wall:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / (1e3 * wall):.1f}%, idle "
          f"{100 - 100 * busy_ms / (1e3 * wall):.1f}%) under the profiler; "
          f"{len(kernels) / WINDOW:.0f} device activities a step", flush=True)
    busy_step = busy_ms / WINDOW
    idle = 1 - busy_step / (1e3 * step_wall)
    to_host = sum("DtoH" in name for name, _ in kernels)
    print(f"{prof_tag} busy {busy_step:.4f} ms of the unprofiled "
          f"{1e3 * step_wall:.4f} ms step: {100 * idle:.1f}% idle; "
          f"{to_host} device-to-host copies in the window "
          f"({to_host / WINDOW:.2f} a step)", flush=True)
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:15]:
        print(f"{prof_tag}   {us / 1e3 / WINDOW:.4f} ms a step, {count} "
              f"launches: {name[:90]}", flush=True)
    return busy_step, idle, to_host


def write_ultra_data() -> str:
    """Phase 8's ULTRA-format dataset (train 512, valid 128, test 128
    queries of the synthetic data) under ``build/``; returns its
    directory."""
    data_dir = os.path.join(WORK, "ultra_data")
    for split, q, seed in (("train", 512, 10), ("valid", 128, 11),
                           ("test", 128, 12)):
        write_ultra_split(data_dir, split, q, seed)
    with open(os.path.join(data_dir, "settings.json"), "w") as fout:
        json.dump({"feature_size": FEATURES, "max_label": 2}, fout)
    return data_dir


def run_module(tag: str, module: str, args, timeout: int = 400) -> str:
    """``python -m <module> <args>`` from the checkout root; its output
    printed under `tag`; fails the run on a non-zero exit."""
    return run_python(tag, ["-m", module] + list(args), timeout)


def run_python(tag: str, args, timeout: int = 400) -> str:
    """``python <args>`` from the checkout root; its output printed under
    `tag`; fails the run on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable] + list(args), cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=timeout)
    for line in proc.stdout.splitlines():
        print(f"[{tag}] {line}", flush=True)
    check(proc.returncode == 0,
          f"{tag} failed:\n{proc.stderr[-3000:]}")
    print(f"[{tag}] ({time.perf_counter() - t0:.1f} s)", flush=True)
    return proc.stdout


MAIN_MARK = "### main "


def run_mains(tag: str, calls, timeout: int = 400):
    """Each ``(module, argv)`` of `calls` as ``module.main(argv)``, which
    is what ``python -m module argv`` runs, in order in one child process
    from the checkout root: one process start (about 8 s to reach the
    card) for them all. Returns each call's lines of standard output;
    fails the run on a non-zero exit."""
    code = ("import importlib\n"
            f"for module, argv in {[(m, list(a)) for m, a in calls]!r}:\n"
            f"    print({MAIN_MARK!r} + module, flush=True)\n"
            "    importlib.import_module(module).main(argv)\n")
    out = run_python(tag, ["-c", code], timeout)
    return [part.splitlines()[1:] for part in out.split(MAIN_MARK)[1:]]


def run_cli(mlp, dev, settings, data_dir: str, tag: str):
    """Train through the CLI of ``python -m ultra_pytorch_tpu_torch.run``
    (2 windows, best checkpoint kept), then ``--test_only`` for the
    ranklist, both in one child process, then a ``Scorer`` on that
    checkpoint against the plain version."""
    from ultra_pytorch_tpu_torch.data.dataset import read_data
    from ultra_pytorch_tpu_torch.serve import Scorer

    stem = os.path.join(WORK, tag.replace(" ", "_"))
    model_dir, out_dir = f"{stem}_model", f"{stem}_out"
    for stale in (model_dir, out_dir):  # an earlier run's checkpoint
        shutil.rmtree(stale, ignore_errors=True)
    setting_file = f"{stem}_settings.json"
    with open(setting_file, "w") as fout:
        json.dump(settings, fout)
    common = ["--data_dir", data_dir, "--setting_file", setting_file,
              "--model_dir", model_dir, "--batch_size", str(BATCH),
              "--device", dev.type]
    module = "ultra_pytorch_tpu_torch.run.__main__"
    run_mains(tag, [(module, common + ["--max_train_iteration",
                                       str(2 * WINDOW),
                                       "--steps_per_checkpoint",
                                       str(WINDOW)]),
                    (module, common + ["--output_dir", out_dir,
                                       "--test_only"])])
    name = settings["learning_algorithm"].rsplit(".", 1)[-1]
    check(os.path.isfile(os.path.join(model_dir, f"{name}.ckpt.npz")),
          f"the CLI saved no {name} checkpoint")
    ranklist = os.path.join(out_dir, "test.ranklist")
    with open(ranklist) as fin:
        lines = fin.read().splitlines()
    check(len(lines) == 128 * LIST and all(len(x.split()) == 6
                                           for x in lines),
          "the ranklist is not one TREC line per test document")
    scorer = Scorer.from_checkpoint(model_dir, device=dev)
    check(scorer.ranker.hparams.use_pallas, "Scorer did not select K1")
    test = read_data(data_dir, "test")
    feats = test.features[test.initial_list[:16]]
    got = torch.from_numpy(scorer.score(feats))
    with torch.inference_mode():
        ref = mlp.fused_mlp_score_reference(
            scorer.ranker.layers,
            torch.from_numpy(feats).to(dev)).cpu()
    err = (got - ref).abs().max().item()
    print(f"[{tag}] ranklist {len(lines)} lines; Scorer on the trained "
          f"{name} checkpoint: 16 queries, max abs err vs the plain version "
          f"{err:.3e}", flush=True)
    check(torch.allclose(got, ref, rtol=TOL, atol=TOL),
          "the served checkpoint disagrees with the plain version")


def phase_cli(mlp, dev, click_json) -> str:
    data_dir = write_ultra_data()
    run_cli(mlp, dev, dla_settings(True, click_json), data_dir, "cli")
    return data_dir


def phase_kernel_timing(mlp, gen, dev, pool):
    """K2 and K5 at the training shapes. ``ms``, ``plain_ms`` and
    ``library_ms`` are device time per call (``graph_ms``); each wrapper's
    back-to-back call time (``time_ms``, which also counts the card waiting
    for the host's next launch) is printed beside them."""
    from ultra_pytorch_tpu_torch.ops.kernels import click_sim

    model = seeded_dnn(HIDDEN, gen, dev)
    n = BATCH * LIST
    x = torch.randn(n, FEATURES, generator=gen).to(dev)
    g = torch.randn(n, generator=gen).to(dev)
    k2_ops, k2_bytes = mlp_bwd_work(model, n)
    print(f"[timing] K2 {n} rows: {k2_ops / 1e9:.3f} GFLOP, "
          f"{k2_bytes / 1e6:.3f} MB", flush=True)

    shape = (WINDOW, pool, LIST)
    gen_c = torch.Generator(device=dev).manual_seed(7)
    probs = torch.rand(shape, generator=gen_c, device=dev)
    mask = (torch.rand(shape, generator=gen_c, device=dev) < 0.9).float()
    key = click_sim.draw_key(gen_c)
    clicks = probs.numel()
    print(f"[timing] K5 window {list(shape)} = {clicks} elements", flush=True)

    # (kernel call, plain version, library call, operations, bytes, peak
    # of the units that do the operations). K2 multiplies as 3xTF32 on the
    # tensor cores; K5 runs on CUDA cores. K5: Philox4x32-10 is 10 rounds of 2 mul.lo, 2 mul.hi, 4 xor and
    # 2 key adds per 4 elements (25 an element), then shift, convert,
    # scale, compare and the mask's multiply: ~30 32-bit operations an
    # element, counted at the float32 CUDA-core rate; it reads probs and
    # mask and writes clicks.
    cases = {
        "K2": (lambda: mlp.mlp_backward(model.layers, x, g, "elu", True),
               lambda: mlp.mlp_backward_reference(
                   model.layers, x, g, "elu", True),
               lambda: library_fwd_bwd(model, x, g), k2_ops, k2_bytes,
               PEAK_3XTF32),
        "K5": (lambda: click_sim.pbm_clicks(probs, mask, key),
               lambda: click_sim.pbm_clicks_reference(probs, mask, key),
               lambda: torch.bernoulli(probs), 30 * clicks,
               12 * clicks + 16, PEAK_F32),
    }
    rows = {}
    for name, (fn, plain, lib, n_ops, n_bytes, peak) in cases.items():
        b_ms, by = bound(n_ops, n_bytes, peak)
        rows[name] = dict(
            ms=graph_ms(fn, 50), plain_ms=graph_ms(plain, 10),
            library_ms=None if lib is None else graph_ms(lib, 50),
            bound_ms=b_ms, bound_by=by,
            bound_f32_ms=bound(n_ops, n_bytes)[0])
        r = rows[name]
        lib_text = "none" if lib is None else f"{r['library_ms']:.4f} ms"
        unit = "3xtf32" if peak == PEAK_3XTF32 else "f32"
        print(f"[timing] {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib_text} (device time a "
              f"call) | wrapper call {time_ms(fn, 100):.4f} ms, plain call "
              f"{time_ms(plain, 20):.4f} ms (back to back) | bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}, at {unit}), kernel "
              f"at {100 * r['bound_ms'] / r['ms']:.2f}% of it; f32 bound "
              f"{r['bound_f32_ms']:.5f} ms "
              f"({100 * r['bound_f32_ms'] / r['ms']:.2f}%)", flush=True)
    return rows


def phase_loss_timing(gen, dev):
    """K3 and K4 at the training shape and at [16384, 10] (many blocks):
    device time a call (``graph_ms``) of the kernel, its plain version and,
    for K3, ``F.cross_entropy`` on precomputed masked scores and targets
    wl / total (a yardstick that does less work: the masking, the label
    weights and the reductions to the residual are done before it);
    beside them the launch floor, the device time of a one-element
    ``zero_()``, against which a kernel whose byte bound is nanoseconds is
    judged."""
    from ultra_pytorch_tpu_torch.ops import losses
    from ultra_pytorch_tpu_torch.ops.kernels import listwise_loss as ll

    tiny = torch.empty(1, device=dev)
    floor_ms = graph_ms(tiny.zero_, 50)
    print(f"[timing] launch floor: one-element zero_() {floor_ms:.4f} ms "
          "(device time a call)", flush=True)
    one = torch.tensor(1.0, device=dev)
    rows = {}
    for batch, length in ((BATCH, LIST), (16384, 10)):
        s, y, w, m = loss_inputs(batch, length, gen, dev)
        _, stats = ll.listwise_loss_forward(s, y, w, m, return_stats=True)
        ref_stats = ll.listwise_loss_stats_reference(s, y, w, m)
        s_masked = torch.where(m > 0, s, torch.full_like(s, -1e9))
        target = (y + 1e-7) * w * m / ref_stats.total
        yard = F.cross_entropy(s_masked, target, reduction="sum")
        check(abs(yard.item() - losses.softmax_loss(s, y, w, m).item())
              <= 1e-4 * abs(yard.item()), "the K3 yardstick computes "
              "another loss")
        k3_ops, k3_bytes, k4_ops, k4_bytes = loss_work(batch, length)
        cases = {
            "K3": (lambda: ll.listwise_loss_forward(s, y, w, m,
                                                    return_stats=True),
                   lambda: (losses.softmax_loss(s, y, w, m),
                            ll.listwise_loss_stats_reference(s, y, w, m)),
                   k3_ops, k3_bytes),
            "K4": (lambda: ll.listwise_loss_backward(s, y, w, m, one, stats),
                   lambda: ll.listwise_loss_backward_reference(
                       s, y, w, m, one, ref_stats), k4_ops, k4_bytes),
        }
        calls = 50 if batch == BATCH else 20
        for name, (fn, plain, n_ops, n_bytes) in cases.items():
            b_ms, by = bound(n_ops, n_bytes)
            r = dict(ms=graph_ms(fn, calls), plain_ms=graph_ms(plain, 10),
                     library_ms=None, bound_ms=b_ms, bound_by=by,
                     bound_f32_ms=b_ms, floor_ms=floor_ms)
            if name == "K3":
                r["yardstick_ms"] = graph_ms(
                    lambda: F.cross_entropy(s_masked, target,
                                            reduction="sum"), calls)
            yard_text = (f", yardstick F.cross_entropy "
                         f"{r['yardstick_ms']:.4f} ms" if name == "K3"
                         else "")
            print(f"[timing] {name} [{batch}, {length}]: kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
                  f"{yard_text} (device time a call) | wrapper call "
                  f"{time_ms(fn, 100):.4f} ms (back to back) | launch floor "
                  f"{floor_ms:.4f} ms, kernel {r['ms'] / floor_ms:.2f}x it | "
                  f"bound {b_ms:.6f} ms ({by}, f32), kernel at "
                  f"{100 * b_ms / r['ms']:.2f}% of it", flush=True)
            if batch == BATCH:
                rows[name] = r
            else:
                rows[name]["large"] = dict(shape=[batch, length], **{
                    k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "yardstick_ms") if k in r})
    return rows


OFFLINE = ("NaiveAlgorithm", "IPWrank", "RegressionEM", "PairDebias",
           "LambdaRank", "PRSrank")
SOFTMAX_ALGOS = ("NaiveAlgorithm", "IPWrank")   # the ones that use K3/K4
OFFLINE_WINDOWS = 2            # windows x WINDOW steps per algorithm
# The reference's estimator JSON (randomized, PBM eta 1), which IPW and
# PRS read in phases 10-11.
ESTIMATOR_JSON = os.path.join(ROOT, "example", "PropensityEstimator",
                              "randomized_pbm_0.1_1.0_4_1.0.json")
SESSIONS = 10_000_000          # the reference estimator's session count
ESTIMATE_TOL = 0.03            # IPW_list[x] against exam[0] / exam[x]


def offline_settings(algo: str, kernels: bool, click_json: str,
                     estimator_json: str = ESTIMATOR_JSON):
    """Phase 7's settings with another algorithm: the estimator JSON for
    IPW and PRS, ``fused_softmax_loss`` for Naive and IPW when the kernels
    are on (the other four have losses of their own)."""
    hp = []
    if algo in ("IPWrank", "PRSrank"):
        hp.append(f"propensity_estimator_json={estimator_json}")
    if kernels and algo in SOFTMAX_ALGOS:
        hp.append("loss_func=fused_softmax_loss")
    settings = dla_settings(kernels, click_json)
    settings.update(learning_algorithm=algo,
                    learning_algorithm_hparams=",".join(hp))
    return settings


def phase_one_step(dev, tag: str, names, settings_of):
    """One step of each of `names` at full width on phase 6's fixed batch,
    kernels on (``settings_of(name, True)``) against the plain path from
    the same initialisation (Regression-EM with the same uniforms): the
    loss within LOSS_TOL relative, the gradient of every trained tensor
    within GRAD_TOL of its largest magnitude."""
    from ultra_pytorch_tpu_torch.run.experiment import create_algorithm

    batch = fixed_batch(dev)
    u = torch.rand((BATCH, LIST), generator=torch.Generator().manual_seed(
        4)).to(dev)
    for name in names:
        out = {}
        for kernels in (True, False):
            settings = settings_of(name, kernels)
            settings.update(max_candidate_num=LIST)
            alg = create_algorithm(settings, FEATURES, 2.0, dev)
            state = alg.init_state(torch.Generator().manual_seed(1))
            extra = (u,) if alg.name == "regression_em" else ()
            loss = alg.losses(state, batch, *extra)[0]
            grads = torch.autograd.grad(loss, alg.trainable(state))
            out[kernels] = (loss.item(),
                            torch.cat([g.reshape(-1) for g in grads]))
        (loss_k, grad_k), (loss_p, grad_p) = out[True], out[False]
        err, rel = max_rel_err(grad_k, grad_p)
        print(f"[{tag}] {name}: loss {loss_k:.6f} vs {loss_p:.6f} "
              f"(rel err {abs(loss_k - loss_p) / abs(loss_p):.3e}, limit "
              f"{LOSS_TOL}); gradient max abs {err:.3e} ({rel:.3e} of its "
              f"largest, limit {GRAD_TOL})", flush=True)
        check(math.isfinite(loss_k), f"{name}: non-finite loss")
        check(abs(loss_k - loss_p) <= LOSS_TOL * abs(loss_p),
              f"{name}: the loss differs between the kernels and the plain "
              "path")
        check(rel <= GRAD_TOL, f"{name}: the gradient differs between the "
              "kernels and the plain path")


def fmt(values) -> str:
    return ", ".join(f"{v:.5f}" for v in values)




def check_aux(algo: str, aux) -> str:
    """The aux state stays in range: Regression-EM's propensity finite in
    [0, 1], PairDebias' and LambdaRank's t+ and t- finite and positive."""
    if algo == "RegressionEM":
        p = aux["propensity"]
        check(bool(torch.isfinite(p).all()) and 0 <= p.min().item()
              and p.max().item() <= 1, f"{algo}: propensity out of [0, 1]")
        return "propensity " + " ".join(f"{v:.3f}" for v in p[0].tolist())
    if algo in ("PairDebias", "LambdaRank"):
        t = torch.stack([aux["t_plus"], aux["t_minus"]])
        check(bool(torch.isfinite(t).all()) and t.min().item() > 0,
              f"{algo}: t+ / t- not finite and positive")
        return ("t+ " + " ".join(f"{v:.3f}" for v in t[0].tolist())
                + " | t- " + " ".join(f"{v:.3f}" for v in t[1].tolist()))
    check(aux is None, f"{algo}: unexpected aux state")
    return "no aux state"


def train_in_turns(tag: str, name: str, settings_of, want, dev, data,
                   turns=(True, False)):
    """`name` for OFFLINE_WINDOWS x WINDOW steps at full width on phase 7's
    data, once for each of `turns` (kernels on or plain, by default on,
    then plain): losses finite, nDCG@10 in [0, 1], the first run's
    launches exactly `want`, a plain run's none. Prints the first run and
    the queries/s of each run's last window (the first holds the capture).
    Returns the runs as (kernels, experiment), the first run's launches
    and the rates by kernels."""
    steps = OFFLINE_WINDOWS * WINDOW
    runs, rates = [], {True: [], False: []}
    for turn, kernels in enumerate(turns):
        reset_counts()
        seconds, metrics, summaries, exp = train_run(
            settings_of(name, kernels), dev, data, 0, OFFLINE_WINDOWS)
        counts = read_counts()
        losses = [m["loss"] for m in metrics]
        online = [m[k] for m in metrics for k in ONLINE_METRICS if k in m]
        check(all(math.isfinite(v) for v in online),
              f"{name}: non-finite online metrics")
        ndcg = [x["ndcg_10"] for x in summaries]
        check(all(math.isfinite(v) for v in losses),
              f"{name}: non-finite training loss")
        check(all(math.isfinite(v) and 0 <= v <= 1 for v in ndcg),
              f"{name}: nDCG@10 out of [0, 1]")
        rates[kernels].append(WINDOW * BATCH / seconds[-1])
        if not kernels:
            check(not any(counts.values()),
                  f"{name}: the plain path launched a kernel")
        if not turn:
            first = counts
            shown = "".join(f"; {k} {fmt([m[k] for m in metrics])}"
                            for k in ONLINE_METRICS if k in metrics[0])
            print(f"[{tag}] {name} kernels on: {steps} steps, launches "
                  f"{counts} (expected {want}); losses {fmt(losses)}"
                  f"{shown}; ndcg_10 {fmt(ndcg)}", flush=True)
            for k, n in want.items():
                check(counts[k] == n, f"{name}: {k} launched {counts[k]} "
                      f"times on the training path, expected {n}")
        runs.append((kernels, exp))
    on, off = rates[True], rates[False]
    order = "/".join("on" if k else "plain" for k in turns)
    print(f"[{tag}] {name} queries/s (host clock, window {OFFLINE_WINDOWS}, "
          f"turns {order}): kernels on "
          f"{' '.join(f'{x:.0f}' for x in on)}, plain "
          f"{' '.join(f'{x:.0f}' for x in off)} "
          f"({sum(on) / len(on) / (sum(off) / len(off)):.2f}x of the means)",
          flush=True)
    return runs, first, rates


def print_rates(tag: str, rates) -> None:
    print(f"[{tag}] queries/s [on..., plain...] on {card_line()}: "
          + json.dumps({k: [round(x) for x in r[True] + r[False]]
                        for k, r in rates.items()}), flush=True)


def phase_offline_training(dev, click_json, data):
    """Each offline algorithm through ``train_in_turns`` with exact launch
    counts, its aux state in range after every run; then phase 7's step
    breakdown for PairDebias. Returns the first kernels-on runs'
    launches, summed."""
    steps = OFFLINE_WINDOWS * WINDOW
    valid_batches = OFFLINE_WINDOWS * math.ceil(
        data["valid"].num_queries / BATCH)
    total = dict.fromkeys(counters(), 0)
    rates, pair_exp = {}, None
    for algo in OFFLINE:
        softmax = algo in SOFTMAX_ALGOS
        want = {"K1": (2 if algo == "RegressionEM" else 1) * steps
                + valid_batches,
                "K2": steps, "K3": steps if softmax else 0,
                "K4": steps if softmax else 0, "K5": OFFLINE_WINDOWS + 1}
        runs, counts, rates[algo] = train_in_turns(
            "offline", algo,
            lambda a, kernels: offline_settings(a, kernels, click_json),
            want, dev, data)
        aux = [check_aux(algo, exp.state.aux) for _, exp in runs]
        print(f"[offline] {algo} after {steps} steps (first run): {aux[0]}",
              flush=True)
        for k, n in counts.items():
            total[k] += n
        if algo == "PairDebias":
            pair_exp = runs[0][1]
    print_rates("offline", rates)
    step_breakdown(pair_exp, " PairDebias")
    return total


def phase_propensity(dev, data, click_json, data_dir) -> str:
    """The randomized estimator at the reference's 10M sessions over
    phase 7's train split (PBM, eta 1): every IPW_list[x] within 3% of
    exam[0] / exam[x]; sessions/s. Then the estimator CLI on phase 8's
    ULTRA data; returns the JSON it wrote."""
    from ultra_pytorch_tpu_torch.sim import propensity as prop
    from ultra_pytorch_tpu_torch.sim.click_models import (
        exam_at_ranks, load_model_from_file)

    model = load_model_from_file(click_json)
    train = data["train"]
    labels = train.labels
    mask = (train.initial_list >= 0).astype(np.float32)
    est = prop.RandomizedPropensityEstimator()
    batch = 1 << 17
    est.estimate_from_model(model, labels, mask, sessions=batch,
                            device=dev)   # warm-up
    t0 = time.perf_counter()
    est.estimate_from_model(model, labels, mask, sessions=SESSIONS,
                            device=dev)   # ends with a device read
    seconds = time.perf_counter() - t0
    run = math.ceil(SESSIONS / batch) * batch
    exam = exam_at_ranks(model, LIST).numpy().astype(np.float64)
    want = exam[0] / exam
    got = np.asarray(est.IPW_list[:LIST])
    rel = np.abs(got / want - 1.0)
    print(f"[propensity] {run} sessions ({batch} a batch) over "
          f"{train.num_queries} queries in {seconds:.3f} s: "
          f"{run / seconds:.4g} sessions/s (host clock)", flush=True)
    print(f"[propensity] IPW_list {np.round(got, 4).tolist()} vs exam[0] / "
          f"exam {np.round(want, 4).tolist()}: max rel err {rel.max():.4f} "
          f"(limit {ESTIMATE_TOL})", flush=True)
    check(len(est.IPW_list) == LIST and bool(np.all(rel <= ESTIMATE_TOL)),
          "the randomized estimate is off PBM's exam[0] / exam")
    out_dir = os.path.join(WORK, "estimator")
    stdout = run_module("propensity cli", "ultra_pytorch_tpu_torch.sim."
                        "propensity", [click_json, data_dir, out_dir,
                                       "--device", dev.type])
    path = stdout.strip().splitlines()[-1]
    cli_est = prop.BasicPropensityEstimator(file_name=path)
    cli_rel = np.abs(np.asarray(cli_est.IPW_list[:LIST]) / want - 1.0)
    print(f"[propensity cli] {path}: IPW_list max rel err vs exam[0] / exam "
          f"{cli_rel.max():.4f}", flush=True)
    check(cli_est.click_model is not None
          and bool(np.all(cli_rel <= ESTIMATE_TOL)),
          "the estimator CLI's JSON is off PBM's exam[0] / exam")
    return path


def phase_offline_cli(mlp, dev, click_json, data, data_dir, estimator_json):
    """IPWrank through the training CLI on the estimator CLI's JSON, then
    ``--test_only`` and a ``Scorer``; then Regression-EM and PairDebias
    Experiments saved and restored into fresh ones: every state leaf, aux
    state included, comes back bit for bit."""
    from ultra_pytorch_tpu_torch.run.experiment import Experiment

    run_cli(mlp, dev, offline_settings("IPWrank", True, click_json,
                                       estimator_json), data_dir, "ipw cli")
    for algo in ("RegressionEM", "PairDebias"):
        model_dir = os.path.join(WORK, f"ckpt_{algo}")
        shutil.rmtree(model_dir, ignore_errors=True)
        exps = []
        for _ in range(2):
            exp = Experiment(offline_settings(algo, True, click_json),
                             "unused", model_dir, batch_size=BATCH, seed=0,
                             device=dev).setup(datasets=data)
            exp.init_state()
            exps.append(exp)
        saved, fresh = exps
        saved.train_steps(WINDOW)
        saved.save({"step": WINDOW})
        check(fresh.restore(), f"{algo}: no checkpoint to restore")
        a = saved.algorithm.state_leaves(saved.state)
        b = fresh.algorithm.state_leaves(fresh.state)
        same = len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))
        aux_same = all(torch.equal(saved.state.aux[k], fresh.state.aux[k])
                       for k in saved.state.aux)
        print(f"[checkpoint] {algo}: {len(a)} leaves after {WINDOW} steps, "
              f"restored bit for bit: {same}; aux {sorted(saved.state.aux)} "
              f"equal: {aux_same}", flush=True)
        check(same and aux_same and fresh.state.step == WINDOW,
              f"{algo}: the restored state differs from the saved one")


# Phase 14: the six configs of configs/ that the new rankers and click
# models bring, at full width: name -> (algorithm, ranker, ranker hparams,
# click model). The rankers at the JAX package's default hparams; the DNN
# at [512, 256, 128].
RANKER_CONFIGS = {
    "dla_ubm": ("DLA", "DNN", HIDDEN, "ubm"),
    "naive_cascade": ("NaiveAlgorithm", "DNN", HIDDEN, "cascade"),
    "dla_setrank": ("DLA", "SetRank",
                    "d_model=256,num_heads=8,num_layers=2,diff=64", "pbm"),
    "dla_dlcm": ("DLA", "DLCM", "embed_size=64,hidden_size=64", "pbm"),
    "naive_gsf": ("NaiveAlgorithm", "GSF",
                  "group_size=2,hidden_layer_sizes=[256, 128]", "pbm"),
    "naive_linear": ("NaiveAlgorithm", "Linear", "", "pbm"),
}
# The configs whose steps phase 14 breaks down, kernels on and plain.
BREAKDOWN_CONFIGS = ("dla_setrank", "dla_dlcm")
CLICK_JSONS = {  # the reference's click-model files
    "pbm": "pbm_0.1_1.0_4_1.0.json", "ubm": "ubm_0.1_1_4_1.0.json",
    "cascade": "cascade_0.1_1.0_4_1.0.json"}


def ranker_settings(config: str, kernels: bool, extra_hparams: str = ""):
    """Phase 7's settings for one of RANKER_CONFIGS, with every kernel
    hparam its path allows when `kernels`: ``use_pallas`` for the DNN,
    ``fused_softmax_loss``, and ``use_pallas_click`` for PBM."""
    algo, ranker, hp, click = RANKER_CONFIGS[config]
    on = "true" if kernels else "false"
    click_json = os.path.join(ROOT, "example", "ClickModel",
                              CLICK_JSONS[click])
    feed = f"click_model_json={click_json}"
    if click == "pbm":
        feed += f",use_pallas_click={on}"
    if ranker == "DNN":
        hp += f",use_pallas={on}"
    hp = ",".join(x for x in (hp, extra_hparams) if x)
    settings = dla_settings(kernels, click_json)
    settings.update(train_input_hparams=feed, ranking_model=ranker,
                    ranking_model_hparams=hp, learning_algorithm=algo)
    return settings


def expected_launches(config: str, steps: int, windows: int,
                      valid_batches: int):
    """The exact launch counts of a kernels-on run of `config`."""
    algo, ranker, _, click = RANKER_CONFIGS[config]
    dnn = ranker == "DNN"
    losses = (2 if algo == "DLA" else 1) * steps
    return {"K1": steps + valid_batches if dnn else 0,
            "K2": steps if dnn else 0, "K3": losses, "K4": losses,
            "K5": windows + 1 if click == "pbm" else 0}


def phase_ranker_clicks(dev):
    """UBM and cascade clicks on the card equal the same function on the
    CPU given the same uniforms (masked lists, eta 1); cascade clicks at
    most once a list."""
    from ultra_pytorch_tpu_torch.sim import click_models as cm

    gen = torch.Generator().manual_seed(5)
    shape = (16384, LIST)
    labels = torch.randint(0, 5, shape, generator=gen).float()
    mask = (torch.rand(shape, generator=gen) < 0.9).float()
    u = torch.rand(shape, generator=gen)
    for name in ("ubm", "cascade"):
        model = cm.load_model_from_file(os.path.join(
            ROOT, "example", "ClickModel", CLICK_JSONS[name]))
        want = cm.clicks_from_uniforms(model, labels, u, mask)
        got = cm.clicks_from_uniforms(model.to(dev), labels.to(dev),
                                      u.to(dev), mask.to(dev))
        same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        per_list = got[0].sum(dim=1)
        print(f"[rankers] {model.model_name} clicks on the card vs the CPU "
              f"on {shape[0]} lists: equal {same}; clicks a list mean "
              f"{per_list.mean().item():.3f} max {per_list.max().item():.0f}",
              flush=True)
        check(same, f"{name} clicks on the card differ from the CPU's")
        if name == "cascade":
            check(per_list.max().item() <= 1, "cascade clicked twice")


def serve_checkpoint(exp, dev, config: str) -> None:
    """Save `exp`, load it with ``Scorer.from_checkpoint`` and serve it over
    HTTP through a ``MicroBatcher``: every reply equals the Scorer's direct
    scoring of that request (lists of 9-16 documents, one list bucket)."""
    from ultra_pytorch_tpu_torch.serve import MicroBatcher, Scorer, \
        make_server

    shutil.rmtree(exp.model_dir, ignore_errors=True)
    exp.save({"step": exp.state.step})
    scorer = Scorer.from_checkpoint(exp.model_dir, device=dev)
    dnn = type(exp.state.params).__name__ == "DNN"
    check(bool(scorer.ranker.hparams.get("use_pallas")) == dnn,
          f"{config}: the Scorer's K1 choice is wrong")
    rng = np.random.default_rng(1)
    requests = [[rng.normal(size=(rng.integers(9, 17), FEATURES))
                 .astype(np.float32) for _ in range(rng.integers(1, 9))]
                for _ in range(6)]
    batcher = MicroBatcher(scorer)
    server = make_server(scorer, port=0, batcher=batcher)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d/v1/rank" % server.server_address

    def post(qs):
        body = json.dumps({"queries": [q.tolist() for q in qs]}).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    try:
        with ThreadPoolExecutor(len(requests)) as pool:
            replies = list(pool.map(post, requests))
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    worst = 0.0
    for qs, out in zip(requests, replies):
        check(len(out["ranked"]) == len(qs), f"{config}: reply lost queries")
        for q, ranked, scores in zip(qs, out["ranked"], out["scores"]):
            direct = scorer.score(q[None])[0]
            got = np.asarray(scores, np.float32)
            check(sorted(ranked) == list(range(len(q)))
                  and got.shape == direct.shape
                  and bool(np.isfinite(got).all()),
                  f"{config}: malformed reply")
            worst = max(worst, float(np.abs(got - direct).max()))
            check(np.allclose(got, direct, rtol=TOL, atol=TOL),
                  f"{config}: a served reply differs from direct scoring")
    print(f"[rankers serve] {config}: {type(scorer.ranker).__name__} "
          f"checkpoint (step {exp.state.step}) served over HTTP, "
          f"{sum(len(qs) for qs in requests)} queries in "
          f"{batcher.device_calls} device calls; max abs diff vs direct "
          f"scoring {worst:.3e}", flush=True)


def phase_rankers(dev, data):
    """Phase 14: the new click models on the card, one step of each of
    RANKER_CONFIGS kernels on vs plain, then each 2 windows x 50 steps on
    phase 7's data in turns (on, plain) with exact launch
    counts (the first run; plain launches nothing), its checkpoint served,
    phase 7's step breakdown for BREAKDOWN_CONFIGS kernels on and plain,
    and SetRank with dropout. Returns the first kernels-on runs'
    launches, summed."""
    phase_ranker_clicks(dev)
    phase_one_step(dev, "rankers step", RANKER_CONFIGS, ranker_settings)
    steps = OFFLINE_WINDOWS * WINDOW
    valid_batches = OFFLINE_WINDOWS * math.ceil(
        data["valid"].num_queries / BATCH)
    total = dict.fromkeys(counters(), 0)
    rates = {}
    for config in RANKER_CONFIGS:
        runs, counts, rates[config] = train_in_turns(
            "rankers", config, ranker_settings,
            expected_launches(config, steps, OFFLINE_WINDOWS, valid_batches),
            dev, data)
        for k, n in counts.items():
            total[k] += n
        serve_checkpoint(runs[0][1], dev, config)
        if config in BREAKDOWN_CONFIGS:
            for kernels, exp in runs[:2]:
                mode = "on" if kernels else "plain"
                step_breakdown(exp, f" {config} {mode}")
    print_rates("rankers", rates)

    # SetRank with dropout: 50 steps draw their masks from the window's
    # generator; eval scoring stays deterministic.
    _, metrics, _, exp = train_run(
        ranker_settings("dla_setrank", True, "rate=0.1"), dev, data, 0, 1)
    losses = [m["loss"] for m in metrics]
    first = exp.test_scores("valid")
    again = exp.test_scores("valid")
    print(f"[rankers] SetRank rate=0.1: {WINDOW} steps, loss "
          f"{fmt(losses)}; eval scores of the valid split equal on a second "
          f"call: {np.array_equal(first, again)}", flush=True)
    check(all(math.isfinite(v) for v in losses) and exp.state.step == WINDOW,
          "SetRank with dropout did not train")
    check(np.array_equal(first, again) and bool(np.isfinite(first).all()),
          "SetRank's eval scores changed between two calls")
    add_launches(total, ranker_click_flag(dev, data))
    return total


def ranker_click_flag(dev, data):
    """UBM and cascade with ``use_pallas_click=true`` and
    ``use_pallas=true``, which the JAX feed runs (its kernel branch is
    PBM's alone): one window of WINDOW steps each, with the flag and
    without, from the same seed. With the flag K5 never launches and the
    other kernels launch exactly (``expected_launches``); the window's
    loss and the window plan's clicks under one generator equal those
    without the flag, bit for bit (every kernel of the path sums in a
    fixed order). Returns the flagged windows' launches."""
    total = dict.fromkeys(counters(), 0)
    valid_batches = math.ceil(data["valid"].num_queries / BATCH)
    for config in ("dla_ubm", "naive_cascade"):
        plans, losses = [], []
        for flag in (",use_pallas_click=true", ""):
            settings = ranker_settings(config, True)
            settings["train_input_hparams"] += flag
            before = read_counts()
            _, metrics, _, exp = train_run(settings, dev, data, 0, 1)
            counts = {k: n - before[k] for k, n in read_counts().items()}
            losses.append(metrics[0]["loss"])
            gen = torch.Generator(device=dev).manual_seed(11)
            plans.append(exp.feeds["train"].train_batch_plan(gen, 0, WINDOW))
            if flag:
                want = expected_launches(config, WINDOW, 1, valid_batches)
                check(exp.feeds["train"].hparams.use_pallas_click
                      and counts == want and counts["K5"] == 0,
                      f"{config} with use_pallas_click=true launched "
                      f"{counts}, expected {want}")
                add_launches(total, counts)
                flagged = counts
        same = all(torch.equal(a, b) for a, b in zip(*plans))
        print(f"[rankers] {config} with use_pallas_click=true and "
              f"use_pallas=true, {WINDOW} steps: launches {flagged}; the "
              f"plan's clicks ({tuple(plans[0][1].shape)}) equal to the "
              f"flag's absence under one generator: {same}; loss "
              f"{losses[0]:.6f} with the flag, {losses[1]:.6f} without",
              flush=True)
        check(same, f"{config}: use_pallas_click=true changed the clicks")
        check(losses[0] == losses[1],
              f"{config}: use_pallas_click=true changed the loss")
        check(all(math.isfinite(v) for v in losses),
              f"{config}: non-finite loss")
    return total


ONLINE = ("naive_online", "pdgd", "dbgd", "dbgd_ndcg", "mgd", "nsgd")
ONLINE_METRICS = ("online_reward", "online_ndcg")
# Candidates a query on the online path: MSLR-WEB10K's mean list length
# (1,200,192 documents over 10,000 queries). The online feeds score and
# rank the whole list every step.
ONLINE_LIST = 120
# K1 launches a training step: the feed's scoring of the whole list, then
# Naive's loss forward; PDGD's no-grad pass and loss forward; the DBGD
# family's current ranker and each of its R candidates.
ONLINE_K1 = {"naive_online": 2, "pdgd": 3, "dbgd": 3, "dbgd_ndcg": 3,
             "mgd": 6, "nsgd": 6}
ONLINE_BREAKDOWN = ("mgd", "nsgd")
ONLINE_CLI = ("pdgd", "nsgd")
ONLINE_SERVED = "nsgd"


def online_settings(config: str, kernels: bool, hidden: str = HIDDEN):
    """``configs/<config>.json`` with the DNN at `hidden` (full width by
    default), ``use_pallas`` when `kernels` (and ``fused_softmax_loss``
    for ``naive_online``'s Naive), L = 10, and its click-model paths
    made absolute."""
    with open(os.path.join(ROOT, "configs", f"{config}.json")) as fin:
        settings = json.loads(fin.read().replace(
            "./example/", os.path.join(ROOT, "example") + "/"))
    on = "true" if kernels else "false"
    settings.update(ranking_model_hparams=f"{hidden},use_pallas={on}",
                    selection_bias_cutoff=LIST, metrics=["ndcg", "mrr"],
                    metrics_topn=[3, 5, 10])
    if kernels and config == "naive_online":
        settings["learning_algorithm_hparams"] = "loss_func=fused_softmax_loss"
    return settings


def online_launches(config: str, steps: int, valid_batches: int):
    """The exact launch counts of a kernels-on run of `config`."""
    backward = config in ("naive_online", "pdgd")
    softmax = steps if config == "naive_online" else 0
    return {"K1": ONLINE_K1[config] * steps + valid_batches,
            "K2": steps if backward else 0, "K3": softmax, "K4": softmax,
            "K5": 0}


def online_batch(dev):
    """Phase 16's fixed batch in an online feed's layout: B lists of
    ONLINE_LIST candidates (a quarter cut to 60), clicks on the top L at
    0.3 (always on the first), grades 0-4 as ``relevance``."""
    rng = np.random.default_rng(6)
    mask = np.ones((BATCH, ONLINE_LIST), np.float32)
    mask[: BATCH // 4, 60:] = 0.0
    clicks = np.zeros((BATCH, ONLINE_LIST), np.float32)
    clicks[:, :LIST] = rng.random((BATCH, LIST)) < 0.3
    clicks[:, 0] = 1.0
    batch = {"features": rng.normal(size=(BATCH, ONLINE_LIST, FEATURES)),
             "labels": clicks, "mask": mask,
             "relevance": rng.integers(0, 5, (BATCH, ONLINE_LIST)) * mask,
             "initial_scores": np.zeros((BATCH, ONLINE_LIST))}
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            for k, v in batch.items()}


def null_memory(rank: int, size: int, gen) -> torch.Tensor:
    """A ``[4, size]`` NSGD memory of rank `rank`: `rank` random unit rows,
    then zero rows (rankers that won) and exact multiples of the random
    rows."""
    rows = torch.randn((4, size), generator=gen)
    rows = rows / rows.norm(dim=1, keepdim=True)
    for j in range(rank, 4):
        rows[j] = 0.0 if j % 2 or not rank else -2.0 * rows[j % rank]
    return rows


def phase_online_checks(dev):
    """The draft on the card equals the CPU's given the same order; the
    DBGD noise of the full-width DNN has unit columns on the card; NSGD's
    samples from a rank-2 memory of every perturbed leaf have unit norm
    and are orthogonal to the stored rows; NSGD's null basis of a memory
    of each rank 0-4 at the first layer's size keeps its properties on the
    card: e_0 ... e_3 at rank 0 exactly, 4 - rank orthonormal rows
    orthogonal to the memory, the rest zero."""
    from ultra_pytorch_tpu_torch.algorithms.nsgd import (
        null_basis, null_space_sample)
    from ultra_pytorch_tpu_torch.models import base
    from ultra_pytorch_tpu_torch.sim.interleave import (
        draft, round_assignments)

    gen = torch.Generator().manual_seed(8)
    n = 5
    # Even lists: the rankers share their first 3 documents; odd lists:
    # independent rankings.
    base_order = torch.rand((BATCH, ONLINE_LIST), generator=gen).argsort(-1)
    perm = torch.rand((BATCH, n, ONLINE_LIST - 3), generator=gen).argsort(-1)
    shared = torch.cat([base_order[:, None, :3].expand(-1, n, -1),
                        torch.gather(base_order[:, None, 3:].expand(
                            -1, n, -1), 2, perm)], dim=-1)
    free = torch.rand((BATCH, n, ONLINE_LIST), generator=gen).argsort(-1)
    even = (torch.arange(BATCH) % 2 == 0)[:, None, None]
    rankings = torch.where(even, shared, free)
    assignments = round_assignments(gen, BATCH, n, LIST)
    want = draft(rankings, assignments, LIST)
    got = draft(rankings.to(dev), assignments.to(dev), LIST)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    prefix = (want[1][::2, :3] == -1).all().item()
    print(f"[online] draft of {n} rankings x {ONLINE_LIST} candidates, "
          f"{BATCH} lists, first {LIST}: card equals CPU {same}; common "
          f"prefix of 3 on half the lists drafted with team -1: {prefix}",
          flush=True)
    check(same and prefix, "the draft on the card differs from the CPU's")

    model = seeded_dnn(HIDDEN, torch.Generator().manual_seed(9), dev)
    cgen = torch.Generator(device=dev).manual_seed(9)
    noise = base.dbgd_noise_like(cgen, model, 4)
    worst = 0.0
    for nz, (t, transposed), noisy in zip(noise, model.jax_leaves(),
                                          base.noise_spec(model)):
        if not noisy:
            check(not nz.any().item(), "DBGD noise on a frozen leaf")
            continue
        norms = torch.linalg.vector_norm(nz, dim=2 if transposed else 1)
        worst = max(worst, (norms - 1).abs().max().item())
    print(f"[online] DBGD noise, 4 at full width: unit columns within "
          f"{worst:.2e}", flush=True)
    check(worst < 1e-5, "DBGD noise columns are not unit on the card")

    worst_norm = worst_dot = 0.0
    for t, transposed in model.jax_leaves():
        shape = t.shape[::-1] if transposed else t.shape
        if t.numel() <= 1:
            continue
        bad = torch.randn((4,) + tuple(shape), generator=cgen, device=dev)
        bad[1] = 0.0
        bad[3] = 0.0
        vec = null_space_sample(cgen, bad).reshape(4, -1)
        losers = bad.reshape(4, -1)[[0, 2]]
        losers = losers / losers.norm(dim=1, keepdim=True)
        worst_norm = max(worst_norm, (vec.norm(dim=1) - 1).abs().max().item())
        worst_dot = max(worst_dot, (vec @ losers.t()).abs().max().item())
    print(f"[online] NSGD null-space samples of every leaf from a rank-2 "
          f"memory on the card: unit within {worst_norm:.2e}, largest "
          f"|cos| with a stored row {worst_dot:.2e} (limit 1e-5)",
          flush=True)
    check(worst_norm < 1e-5 and worst_dot < 1e-5,
          "NSGD's samples leave the null space on the card")

    size = FEATURES * 512
    for rank in range(5):
        bad = null_memory(rank, size, gen)
        basis = null_basis(bad.to(dev)).cpu()
        kept = 4 - rank
        ortho = ((basis[:kept] @ basis[:kept].t() - torch.eye(kept))
                 .abs().max().item() if kept else 0.0)
        stored = bad[:rank] / bad[:rank].norm(dim=1, keepdim=True)
        dots = (basis @ stored.t()).abs().max().item() if rank else 0.0
        zero_rest = not basis[kept:].any().item()
        exact = rank or torch.equal(basis, torch.eye(4, size))
        print(f"[online] NSGD null basis of a rank-{rank} [4, {size}] memory "
              f"on the card: {kept} rows orthonormal within {ortho:.2e}, "
              f"largest |cos| with a stored row {dots:.2e}, the rest zero "
              f"{zero_rest}" + ("" if rank else
                                f", e_0 ... e_3 exactly {exact}"),
              flush=True)
        check(ortho < 1e-5 and dots < 1e-5 and zero_rest and exact,
              f"NSGD's null basis of a rank-{rank} memory breaks its "
              "properties on the card")


def order_flips(a, b, mask, top: int):
    """Lists whose top-`top` order by scores `a` differs from that by `b`,
    and the smallest gap between adjacent sorted scores of `b` within each
    such list's top + 1."""
    from ultra_pytorch_tpu_torch.sim.sampling import deterministic_rank

    ra = deterministic_rank(a, mask)[:, :top]
    rb = deterministic_rank(b, mask)[:, :top + 1]
    flipped = (ra != rb[:, :top]).any(dim=1)
    sorted_b = torch.gather(b, 1, rb)
    gaps = (sorted_b[:, :-1] - sorted_b[:, 1:]).abs().min(dim=1).values
    return flipped, gaps


def phase_online_step(dev):
    """One step of each online config at full width on a fixed batch of
    ONLINE_LIST candidates, kernels on against plain from the same
    initialisation. Naive and PDGD: the loss within LOSS_TOL relative and
    the gradient within GRAD_TOL of its largest. The DBGD family, given
    the same noises (the same generator's draws) and the winners that the
    plain path's scores give: every candidate's scores within TOL, the
    parameter delta within GRAD_TOL of its largest, and the loss (1 -
    nDCG@10, a step function of the scores) within LOSS_TOL relative plus
    1 / B for each list whose top-10 order differs between the two paths,
    each such list holding a near tie (two plain scores within 2 TOL)."""
    from ultra_pytorch_tpu_torch.run.experiment import create_algorithm

    batch = online_batch(dev)
    for config in ONLINE:
        out = {}
        for kernels in (False, True):
            settings = online_settings(config, kernels)
            settings.update(max_candidate_num=ONLINE_LIST)
            alg = create_algorithm(settings, FEATURES, 4.0, dev)
            state = alg.init_state(torch.Generator().manual_seed(1))
            if not hasattr(alg, "candidate_scores"):
                loss = alg.losses(state, batch)[0]
                grads = torch.autograd.grad(loss, alg.trainable(state))
                out[kernels] = (loss, torch.cat([g.reshape(-1)
                                                 for g in grads]), None)
                continue
            gen = torch.Generator(device=dev).manual_seed(7)
            noises = alg.sample_noises(state, gen)
            scores = alg.candidate_scores(state, batch, noises, gen)
            if not kernels:   # the plain path's winners, for both
                share = (alg.interleave_winners(scores, batch, gen)[0]
                         .mean(dim=0) if alg.hparams.need_interleave
                         else alg.ndcg_winners(scores, batch))
            before = torch.cat([t.reshape(-1).clone()
                                for t, _ in state.params.jax_leaves()])
            alg.apply_noise_update(state, noises, share)
            after = torch.cat([t.reshape(-1)
                               for t, _ in state.params.jax_leaves()])
            out[kernels] = (alg.ranking_loss(scores[0], batch),
                            after - before, torch.stack(scores))
        (loss_k, delta_k, s_k), (loss_p, delta_p, s_p) = out[True], out[False]
        loss_k, loss_p = loss_k.item(), loss_p.item()
        err, rel = max_rel_err(delta_k, delta_p)
        what = "gradient" if s_k is None else "parameter delta"
        allowed, note = LOSS_TOL * abs(loss_p), ""
        if s_k is not None:
            s_err = (s_k - s_p).abs().max().item()
            flipped, gaps = order_flips(s_k[0], s_p[0], batch["mask"], LIST)
            n_flip = int(flipped.sum())
            allowed += n_flip / BATCH
            note = (f"; {s_k.shape[0]} score lists max abs err {s_err:.3e} "
                    f"(limit {TOL}); {n_flip} lists' top-{LIST} order "
                    "differs")
            check(torch.allclose(s_k, s_p, rtol=TOL, atol=TOL),
                  f"{config}: candidate scores differ between K1 and plain")
            scale = 2 * TOL * (1 + s_p[0].abs().max().item())
            check(bool((gaps[flipped] <= scale).all()),
                  f"{config}: a top-{LIST} order differs without a near tie")
        print(f"[online step] {config}: loss {loss_k:.6f} vs {loss_p:.6f} "
              f"(abs diff {abs(loss_k - loss_p):.3e}, limit {allowed:.3e}); "
              f"{what} max abs {err:.3e} ({rel:.3e} of its largest, limit "
              f"{GRAD_TOL}){note}", flush=True)
        check(math.isfinite(loss_k), f"{config}: non-finite loss")
        check(abs(loss_k - loss_p) <= allowed,
              f"{config}: the loss differs between the kernels and plain")
        check(rel <= GRAD_TOL, f"{config}: the {what} differs between the "
              "kernels and the plain path")


def online_step_breakdown(exp, tag: str) -> None:
    """Phase 7's step breakdown for a DBGD-family run, eager: the feed's
    batch (its K1 scoring of the whole list, the ranking, the clicks), the
    noises (NSGD's Gram-Schmidt null bases), the candidates' scoring, the
    winners (rankings, draft, clicks) and the update (with the aux state
    and the loss). Phase 20 profiles the eager and the graph window."""
    feed, alg = exp.feeds["train"], exp.algorithm

    def window(record):
        gen = exp._window_generator()
        for _ in range(WINDOW):
            a = mark()
            batch = feed.train_batch(gen, exp.state)
            b = mark()
            noises = alg.sample_noises(exp.state, gen)
            c = mark()
            scores = alg.candidate_scores(exp.state, batch, noises, gen)
            d = mark()
            winners = alg.interleave_winners(scores, batch, gen)[0]
            e = mark()
            alg.update_aux_(exp.state, noises, winners.sum(dim=0))
            alg.apply_noise_update(exp.state, noises, winners.mean(dim=0))
            alg.ranking_loss(scores[0], batch)
            f = mark()
            for p, x, y in (("feed", a, b), ("noise", b, c),
                            ("candidates", c, d), ("winners", d, e),
                            ("update", e, f)):
                record(p, x, y)

    time_parts(f"[step {tag}]", ("feed", "noise", "candidates", "winners",
                                 "update"), window)


def phase_online(mlp, dev, data_dir):
    """Phase 16: the online family. Phase 16's checks, one step of each
    config kernels on vs plain, then each config 2 windows x 50 steps at
    full width on 4,096 synthetic queries of ONLINE_LIST candidates in
    turns on, plain with exact launch counts (the first run;
    plain launches nothing) and finite online metrics; the step breakdown
    of ONLINE_BREAKDOWN kernels on; the NSGD checkpoint served over HTTP;
    the CLI for ONLINE_CLI on phase 8's data. Returns the first
    kernels-on runs' launches, summed, and the data."""
    phase_online_checks(dev)
    phase_online_step(dev)
    data = {"train": synthetic(4096, 20, ONLINE_LIST),
            "valid": synthetic(1024, 21, ONLINE_LIST)}
    steps = OFFLINE_WINDOWS * WINDOW
    valid_batches = OFFLINE_WINDOWS * math.ceil(
        data["valid"].num_queries / BATCH)
    total = dict.fromkeys(counters(), 0)
    rates = {}
    for config in ONLINE:
        runs, counts, rates[config] = train_in_turns(
            "online", config, online_settings,
            online_launches(config, steps, valid_batches), dev, data)
        for k, n in counts.items():
            total[k] += n
        if config in ONLINE_BREAKDOWN:
            online_step_breakdown(runs[0][1], f"{config} on")
        if config == ONLINE_SERVED:
            serve_checkpoint(runs[0][1], dev, config)
    print_rates("online", rates)
    for config in ONLINE_CLI:
        run_cli(mlp, dev, online_settings(
            config, True, "hidden_layer_sizes=[64, 32]"), data_dir,
            f"online cli {config}")
    return total, data


# -- phase 17: the libsvm and ULTRE formats --------------------------------
# MSLR-WEB10K's shape: FEATURES features, grades 0-4, FORMAT_DOCS documents
# a query (its mean list length); FORMAT_QUERIES of them a split.
FORMAT_DOCS = ONLINE_LIST
FORMAT_QUERIES = {"train": 1024, "valid": 256, "test": 256}
FORMAT_DECIMALS = 4            # features printed as d.dddd, in [0, 10)


def letor_arrays(num_queries: int, seed: int):
    """(features as integers k for k / 10^FORMAT_DECIMALS, grades) of
    `num_queries` queries of FORMAT_DOCS documents, each query's first
    document relevant."""
    rng = np.random.default_rng(seed)
    rows = num_queries * FORMAT_DOCS
    ints = rng.integers(0, 10 ** (FORMAT_DECIMALS + 1), size=(rows, FEATURES))
    grades = rng.integers(0, 5, size=rows)
    grades[::FORMAT_DOCS] = np.maximum(grades[::FORMAT_DOCS], 1)
    return ints, grades


def text_rows(head: str, head_values, ints) -> bytes:
    """One line a row: `head` (whose ``#`` characters take `head_values`'
    digits, ``[rows, n#]``), then `` i:d.dddd`` for every feature, built as
    one byte matrix (vectorised, no per-row formatting)."""
    rows = ints.shape[0]
    template, digit_cols = bytearray(head.encode()), []
    hash_cols = [i for i, c in enumerate(head) if c == "#"]
    for j in range(FEATURES):
        template += f" {j + 1}:".encode()
        digit_cols.append(len(template))
        template += b"0." + b"0" * FORMAT_DECIMALS
    template += b"\n"
    out = np.tile(np.frombuffer(bytes(template), np.uint8), (rows, 1))
    powers = 10 ** np.arange(FORMAT_DECIMALS, -1, -1)
    digits = (ints[:, :, None] // powers) % 10            # [rows, F, 5]
    cols = np.asarray(digit_cols)[:, None] + np.array(
        [0] + list(range(2, FORMAT_DECIMALS + 2)))        # skip the point
    out[:, cols.reshape(-1)] = (digits.reshape(rows, -1) + 48).astype(
        np.uint8)
    if hash_cols:
        out[:, hash_cols] = (np.asarray(head_values) + 48).astype(np.uint8)
    return out.tobytes()


def id_digits(values, width: int):
    """Decimal digits ``[n, width]`` of non-negative integers."""
    return (np.asarray(values)[:, None]
            // 10 ** np.arange(width - 1, -1, -1)) % 10


def write_format_data(seed: int):
    """Phase 17's data: a libsvm directory (``<split>/<split>.txt``) and its
    ULTRE twin (did-keyed ``.feature``, ``qid did ...`` lists, the data's
    grades, and a click-model directory of logged clicks for train).
    Returns (libsvm dir, ULTRE dir, click dir, arrays by split, seconds,
    megabytes of libsvm text)."""
    base = os.path.join(WORK, "formats")
    shutil.rmtree(base, ignore_errors=True)
    libsvm_dir, ultre_dir = os.path.join(base, "libsvm"), os.path.join(
        base, "ultre")
    click_dir = os.path.join(ultre_dir, "clicks")
    os.makedirs(click_dir)
    with open(os.path.join(ultre_dir, "settings.json"), "w") as fout:
        json.dump({"feature_size": FEATURES, "max_label": 4}, fout)
    t0, nbytes, arrays = time.perf_counter(), 0, {}
    first_qid = 0
    for i, (split, q) in enumerate(FORMAT_QUERIES.items()):
        ints, grades = letor_arrays(q, seed + i)
        qids = np.repeat(np.arange(first_qid, first_qid + q), FORMAT_DOCS)
        first_qid += q
        clicks = (np.random.default_rng(seed + 10 + i).random(
            grades.shape) < 0.2).astype(np.int64)
        clicks[::FORMAT_DOCS] = 1
        arrays[split] = (ints, grades, qids, clicks)
        text = text_rows("# qid:#####", np.concatenate(
            [grades[:, None], id_digits(qids, 5)], 1), ints)
        nbytes += len(text) if split == "train" else 0
        for d in (libsvm_dir, ultre_dir):
            os.makedirs(os.path.join(d, split))
        with open(os.path.join(libsvm_dir, split, f"{split}.txt"),
                  "wb") as fout:
            fout.write(text)
        rows = np.arange(len(grades)) + 10 ** 7 * (i + 1)
        with open(os.path.join(ultre_dir, split, f"{split}.feature"),
                  "wb") as fout:
            fout.write(text_rows("d########", id_digits(rows, 8), ints))
        lists = rows.reshape(q, FORMAT_DOCS)
        with open(os.path.join(ultre_dir, split, f"{split}.init_list"),
                  "w") as fout:
            fout.writelines(f"{qid:05d} " + " ".join(f"d{r}" for r in docs)
                            + "\n" for qid, docs in zip(
                                qids[::FORMAT_DOCS], lists))
        for path, values in ((os.path.join(ultre_dir, split,
                                           f"{split}.labels"), grades),
                             (os.path.join(click_dir, f"{split}.labels"),
                              clicks)):
            if path.startswith(click_dir) and split != "train":
                continue
            with open(path, "w") as fout:
                fout.writelines(
                    f"{qid:05d} " + " ".join(map(str, v)) + "\n"
                    for qid, v in zip(qids[::FORMAT_DOCS],
                                      values.reshape(q, FORMAT_DOCS)))
    return (libsvm_dir, ultre_dir, click_dir, arrays,
            time.perf_counter() - t0, nbytes / 1e6)


def run_cli_here(tag: str, argv) -> str:
    """``ultra_pytorch_tpu_torch.run``'s ``main(argv)`` in this process (so
    its kernel launches are counted here); its output printed under
    `tag`."""
    import contextlib
    import io

    from ultra_pytorch_tpu_torch.run import __main__ as cli

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(list(argv))
    for line in out.getvalue().splitlines():
        print(f"[{tag}] {line}", flush=True)
    print(f"[{tag}] ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out.getvalue()


def cli_launches(steps: int, windows: int, valid_queries: int):
    """Exact launches of a DLA CLI run with every kernel on: K1 once a
    step and once a validation batch, K2 once a step, K3 and K4 twice, K5
    once a window plus the feed's click-rate estimate."""
    return {"K1": steps + windows * math.ceil(valid_queries / BATCH),
            "K2": steps, "K3": 2 * steps, "K4": 2 * steps,
            "K5": windows + 1}


def phase_formats(click_json):
    """Phase 17: the libsvm and ULTRE loaders with the native parser at
    MSLR-WEB10K's shape, and DLA trained through the CLI on both. Returns
    the data directories and the main path's launches."""
    from ultra_pytorch_tpu_torch.data import dataset as data_lib
    from ultra_pytorch_tpu_torch.data import native

    (libsvm_dir, ultre_dir, click_dir, arrays, write_s,
     megabytes) = write_format_data(17)
    ints, grades, qids, clicks = arrays["train"]
    print(f"[formats] wrote {len(grades)} train rows ({megabytes:.1f} MB of "
          f"libsvm text) and the valid/test splits, each also as ULTRE, in "
          f"{write_s:.2f} s", flush=True)
    check(native.native_available(), "the native LETOR parser did not build")
    parses = native.parse_letor_file.parses
    t0 = time.perf_counter()
    ds = data_lib.read_data(libsvm_dir, "train")
    load_s = time.perf_counter() - t0
    check(native.parse_letor_file.parses == parses + 1,
          "the libsvm loader did not go through the native parser")
    want = (ints / 10 ** FORMAT_DECIMALS).astype(np.float32)
    check(np.array_equal(ds.features, want), "parsed libsvm features differ "
          "from the written ones")
    check(np.array_equal(ds.labels.reshape(-1), grades.astype(np.float32))
          and ds.qids == [f"{q:05d}" for q in qids[::FORMAT_DOCS]]
          and ds.dids[:2] == ["00000_0", "00000_1"]
          and ds.max_label == 4.0 and ds.rank_list_size == FORMAT_DOCS,
          "parsed libsvm grades, qids or dids differ from the written ones")
    print(f"[formats] libsvm train loaded natively in {load_s:.3f} s: "
          f"{len(grades) / load_s:.0f} rows/s, {megabytes / load_s:.1f} MB/s; "
          "features, grades, qids and dids exact", flush=True)
    t0 = time.perf_counter()
    twin = data_lib.read_data(ultre_dir, "train", None, click_dir)
    load_s = time.perf_counter() - t0
    check(np.array_equal(twin.features, want)
          and np.array_equal(twin.labels.reshape(-1),
                             clicks.astype(np.float32))
          and not np.array_equal(twin.labels, ds.labels),
          "the ULTRE loader did not read the features or did not take the "
          "click-model directory's labels")
    print(f"[formats] ULTRE train loaded in {load_s:.3f} s with the "
          f"click-model directory's labels ({twin.labels.mean():.3f} "
          f"clicked) in place of the grades ({ds.labels.mean():.3f} mean)",
          flush=True)

    settings_file = os.path.join(WORK, "formats", "dla_settings.json")
    with open(settings_file, "w") as fout:
        json.dump(dla_settings(True, click_json), fout)
    model_dir = os.path.join(WORK, "formats", "model")
    common = ["--setting_file", settings_file, "--batch_size", str(BATCH),
              "--steps_per_checkpoint", str(WINDOW), "--dp", "off",
              "--device", "cuda"]
    valid_q = FORMAT_QUERIES["valid"]
    runs = (
        ("libsvm", ["--data_dir", libsvm_dir, "--model_dir", model_dir,
                    "--max_train_iteration", str(2 * WINDOW)],
         cli_launches(2 * WINDOW, 2, valid_q)),
        ("ULTRE", ["--data_dir", ultre_dir, "--model_dir",
                   model_dir + "_ultre", "--data_format", "ULTRE",
                   "--click_model_dir", click_dir,
                   "--max_train_iteration", str(WINDOW)],
         cli_launches(WINDOW, 1, valid_q)),
        ("libsvm test", ["--data_dir", libsvm_dir, "--model_dir", model_dir,
                         "--output_dir", model_dir + "_out", "--test_only"],
         {"K1": 2 * math.ceil(FORMAT_QUERIES["test"] / BATCH), "K2": 0,
          "K3": 0, "K4": 0, "K5": 0}),
    )
    total = dict.fromkeys(counters(), 0)
    for name, argv, expected in runs:
        reset_counts()
        out = run_cli_here(f"formats {name}", common + argv)
        counts = read_counts()
        print(f"[formats] {name}: launches {counts} (expected {expected})",
              flush=True)
        check(counts == expected, f"{name} CLI launches {counts}, expected "
              f"{expected}")
        losses = [float(x) for x in re.findall(r"^step \d+ loss (\S+)", out,
                                               re.M)]
        check(all(math.isfinite(v) for v in losses), f"{name}: non-finite "
              "training loss")
        for k, n in counts.items():
            total[k] += n
    with open(os.path.join(model_dir + "_out", "test.ranklist")) as fin:
        lines = fin.read().splitlines()
    check(len(lines) == FORMAT_QUERIES["test"] * FORMAT_DOCS,
          "the libsvm ranklist is not one line per test document")
    return libsvm_dir, total


# -- phase 18: data parallelism on one card --------------------------------
DP_RANKS = 2
DP_CLIP = 0.05        # binds: the mean gradient's norm is above it (printed)


def given_step_settings(click_json):
    settings = dla_settings(True, click_json)
    settings.update(max_candidate_num=LIST, learning_algorithm_hparams=(
        "loss_func=fused_softmax_loss,grad_strategy=sgd,learning_rate=1.0,"
        f"max_gradient_norm={DP_CLIP}"))
    return settings


def dp_window_run(settings, data_dir, model_dir, dev, windows: int,
                  dp="auto", shard_data=False, seed=0):
    """An Experiment (a rank of this process's group unless `dp` is
    "off") trained `windows` x WINDOW steps, the whole valid split
    validated after each, as the CLI does: (experiment, per-window
    metrics, seconds, and whether the state was the same on every rank
    after each window)."""
    from ultra_pytorch_tpu_torch.parallel import same_on_every_rank
    from ultra_pytorch_tpu_torch.run.experiment import Experiment

    exp = Experiment(dict(settings), data_dir, model_dir, batch_size=BATCH,
                     seed=seed, dp=dp, shard_data=shard_data, device=dev)
    exp.setup()
    exp.init_state()
    metrics, seconds, same = [], [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(exp.train_steps(WINDOW))
        seconds.append(time.perf_counter() - t0)
        metrics[-1].update(exp.validate("valid"))
        if exp.data_parallel:
            same.append(same_on_every_rank(
                exp.algorithm.state_leaves(exp.state), dev))
    return exp, metrics, seconds, same


def dp_rank(rank, world, init_method, click_json, ultra_dir, long_dir,
            model_dirs):
    """Phase 18 on one of two gloo ranks that share cuda:0."""
    import torch.distributed as dist

    from ultra_pytorch_tpu_torch.data.dataset import read_data
    from ultra_pytorch_tpu_torch.parallel import (
        all_reduce_mean, close_data_parallel, init_data_parallel,
        shard_queries_for_host)
    from ultra_pytorch_tpu_torch.run.experiment import create_algorithm
    from ultra_pytorch_tpu_torch.run.launch import host_threads
    from ultra_pytorch_tpu_torch.utils.checkpoint import tree_leaves

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(host_threads(world))
    init_data_parallel(world, rank, dev, backend="gloo",
                       init_method=init_method)
    out = {}
    try:
        # The main path: DLA, every kernel on, counts from 0.
        reset_counts()
        exp, metrics, _, same = dp_window_run(
            dla_settings(True, click_json), ultra_dir, model_dirs[rank], dev,
            2)
        out["dla"] = {"counts": read_counts(), "metrics": metrics,
                      "same": same, "batch": exp.feeds["train"].batch_size}
        exp.save({"step": exp.state.step})

        # One step on this rank's half of phase 6's batch.
        alg = create_algorithm(given_step_settings(click_json), FEATURES,
                               2.0, dev)
        state = alg.init_state(torch.Generator().manual_seed(1))
        half = BATCH // world
        batch = {k: v[rank * half:(rank + 1) * half]
                 for k, v in fixed_batch(dev).items()}
        alg.grad_sync = all_reduce_mean
        state, m = alg.train_step(state, batch)
        out["given"] = (m["loss"].item(), alg.state_leaves(state))

        # The aux state of Regression-EM and PairDebias, and MGD's
        # parameters at Lc = ONLINE_LIST with R = 4.
        for name, settings, data_dir in (
                ("RegressionEM", offline_settings("RegressionEM", True,
                                                  click_json), ultra_dir),
                ("PairDebias", offline_settings("PairDebias", True,
                                                click_json), ultra_dir),
                ("mgd", online_settings("mgd", True), long_dir)):
            exp, metrics, _, same = dp_window_run(settings, data_dir,
                                                  "unused", dev, 1)
            out[name] = {"same": same, "metrics": metrics,
                         "aux": len(tree_leaves(exp.state.aux))}

        # --shard_data: this rank's train split is its stripe.
        exp, _, _, same = dp_window_run(dla_settings(True, click_json),
                                        ultra_dir, "unused", dev, 1,
                                        shard_data=True)
        stripe = shard_queries_for_host(read_data(ultra_dir, "train"), rank,
                                        world)
        out["stripe"] = {
            "same": same,
            "equal": bool(np.array_equal(exp.datasets["train"].features,
                                         stripe.features)
                          and exp.datasets["train"].qids == stripe.qids),
            "rows": int(stripe.features.shape[0])}

        # The flat gradient's all-reduce (the ranker and the tower).
        n = sum(p.numel() for p in exp.algorithm.trainable(exp.state))
        g = torch.randn(n, device=dev)
        for _ in range(5):
            all_reduce_mean(g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            all_reduce_mean(g)
        torch.cuda.synchronize()
        out["all_reduce"] = ((time.perf_counter() - t0) / 50 * 1e3, 4 * n)

        # Queries/s in turns: one rank alone (rank 0; rank 1 waits), then
        # two ranks, two ranks, one rank alone; the second window of each.
        rates = []
        for ranks in (1, 2, 2, 1):
            dist.barrier()
            if ranks == 1:
                if rank == 0:
                    _, _, seconds, _ = dp_window_run(
                        dla_settings(True, click_json), ultra_dir, "unused",
                        dev, 2, dp="off")
                    rates.append((1, WINDOW * BATCH / seconds[-1]))
                continue
            _, _, seconds, _ = dp_window_run(
                dla_settings(True, click_json), ultra_dir, "unused", dev, 2)
            rates.append((2, WINDOW * (BATCH // world) / seconds[-1]))
        dist.barrier()
        out["rates"] = rates
        return out
    finally:
        close_data_parallel()


def phase_dp(dev, click_json, ultra_dir, long_dir):
    """Phase 18: two gloo ranks sharing cuda:0, then NCCL at world size 1.
    Returns the main path's launches (both ranks)."""
    from ultra_pytorch_tpu_torch.parallel import spawn_ranks
    from ultra_pytorch_tpu_torch.run.experiment import create_algorithm

    base = os.path.join(WORK, "dp")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    model_dirs = [os.path.join(base, f"model{r}") for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_rank, DP_RANKS, (
        f"file://{os.path.join(base, 'store')}", click_json, ultra_dir,
        long_dir, model_dirs), timeout=600)
    print(f"[dp] {DP_RANKS} gloo ranks on cuda:0 ran in "
          f"{time.perf_counter() - t0:.1f} s (spawn included)", flush=True)

    from ultra_pytorch_tpu_torch.data.dataset import read_data

    want = cli_launches(2 * WINDOW, 2,
                        read_data(ultra_dir, "valid").num_queries)
    total = dict.fromkeys(counters(), 0)
    for r, res in enumerate(ranks):
        dla = res["dla"]
        print(f"[dp] rank {r}: {dla['batch']} queries a step, launches "
              f"{dla['counts']} (expected {want}); losses "
              f"{fmt([m['loss'] for m in dla['metrics']])}; state identical "
              f"across ranks after each window {dla['same']}; ndcg_10 "
              f"{fmt([m['ndcg_10'] for m in dla['metrics']])}", flush=True)
        check(dla["counts"] == want, f"rank {r} launched {dla['counts']}, "
              f"expected {want}")
        check(all(dla["same"]), f"rank {r}'s state differs from rank 0's")
        check(dla["batch"] == BATCH // DP_RANKS, "a rank's batch is not B/N")
        for k, n in dla["counts"].items():
            total[k] += n
    check(ranks[0]["dla"]["metrics"] == ranks[1]["dla"]["metrics"],
          "the ranks' window metrics or validation differ")
    check(all(math.isfinite(m["loss"]) for m in ranks[0]["dla"]["metrics"]),
          "non-finite data-parallel loss")

    # One step given the shards: the mean of the shards' gradients.
    alg = create_algorithm(given_step_settings(click_json), FEATURES, 2.0,
                           dev)
    state = alg.init_state(torch.Generator().manual_seed(1))
    leaves0 = alg.state_leaves(state)
    batch, half = fixed_batch(dev), BATCH // DP_RANKS
    losses, grads = [], []
    for r in range(DP_RANKS):
        shard = {k: v[r * half:(r + 1) * half] for k, v in batch.items()}
        loss = alg.losses(state, shard)[0]
        losses.append(loss.item())
        grads.append(torch.autograd.grad(loss, alg.trainable(state)))
    mean = [(a + b) / 2 for a, b in zip(*grads)]
    n_rank = len(state.params.jax_leaves())
    norms = [torch.sqrt(sum((g * g).sum() for g in part)).item()
             for part in (mean[:n_rank], mean[n_rank:])]
    alg.apply_gradients(state, mean)
    want_leaves = alg.state_leaves(state)
    n = len(want_leaves) - 1
    want_delta = [w - w0 for w, w0 in zip(want_leaves[:n], leaves0[:n])]
    scale = max(np.abs(d).max() for d in want_delta)
    for r, res in enumerate(ranks):
        loss, got = res["given"]
        err = max(np.abs((g - w0) - d).max() for g, w0, d in zip(
            got[:n], leaves0[:n], want_delta))
        print(f"[dp] given shards, rank {r}: loss {loss:.6f} vs {losses[r]:.6f}"
              f" (rel {abs(loss - losses[r]) / abs(losses[r]):.2e}, limit "
              f"{LOSS_TOL}); update max abs err {err:.3e} ({err / scale:.2e} "
              f"of its largest, limit {GRAD_TOL}); mean-gradient norms "
              f"{norms[0]:.4f} (ranker), {norms[1]:.4f} (tower) against the "
              f"clip {DP_CLIP}", flush=True)
        check(abs(loss - losses[r]) <= LOSS_TOL * abs(losses[r]),
              f"rank {r}'s loss on its shard differs")
        check(err <= GRAD_TOL * scale, f"rank {r}'s update differs from the "
              "mean-gradient step")
    check(min(norms) > DP_CLIP, "the clip does not bind")

    for name in ("RegressionEM", "PairDebias", "mgd"):
        res = [r[name] for r in ranks]
        print(f"[dp] {name}: one window, state ({res[0]['aux']} aux leaves "
              f"among them) identical across ranks {res[1]['same']}; loss "
              f"{res[0]['metrics'][0]['loss']:.5f}", flush=True)
        check(all(all(x["same"]) for x in res)
              and res[0]["metrics"] == res[1]["metrics"],
              f"{name}: the ranks' state or metrics differ")
    for r, res in enumerate(ranks):
        st = res["stripe"]
        print(f"[dp] --shard_data rank {r}: {st['rows']} feature rows, its "
              f"stripe exactly {st['equal']}", flush=True)
        check(st["equal"] and all(st["same"]),
              f"rank {r}'s train split is not its stripe")
    ms, nbytes = ranks[0]["all_reduce"]
    print(f"[dp] gloo all-reduce of the flat gradient ({nbytes / 1e6:.2f} "
          f"MB, two ranks on one card): {ms:.3f} ms a call", flush=True)
    alone = [q for k, q in ranks[0]["rates"] if k == 1]
    pairs = zip(*([q for k, q in r["rates"] if k == 2] for r in ranks))
    both = [sum(pair) for pair in pairs]
    print(f"[dp] queries/s (host clock, window 2 of 2, turns 1/2/2/1 ranks; "
          f"two ranks summed) on {card_line()}: one rank {alone[0]:.0f} "
          f"{alone[1]:.0f}, two ranks {both[0]:.0f} {both[1]:.0f} -- a "
          "one-card gloo figure, not multi-card scaling", flush=True)

    # The checkpoint: rank 0's alone, restored by one process.
    names = [sorted(f for f in os.listdir(d) if f.endswith(".ckpt.npz"))
             if os.path.isdir(d) else [] for d in model_dirs]
    check(names == [["DLA.ckpt.npz"], []], f"checkpoints written {names}")
    settings_file = os.path.join(base, "dla_settings.json")
    with open(settings_file, "w") as fout:
        json.dump(dla_settings(True, click_json), fout)
    out = run_cli_here("dp test_only", [
        "--data_dir", ultra_dir, "--setting_file", settings_file,
        "--model_dir", model_dirs[0], "--output_dir", base + "/out",
        "--batch_size", str(BATCH), "--test_only", "--device", "cuda"])
    check("Restored checkpoint from" in out, "the data-parallel checkpoint "
          "did not restore in one process")
    phase_nccl(dev, click_json, ultra_dir, base)
    return total


def nccl_kernels(events):
    """NCCL's kernels among torch.profiler's device events (ncclDevKernel_*,
    or oneRankReduce at one rank), not the "nccl:all_reduce" annotation
    torch records beside them."""
    return [name for name, _ in events
            if ("nccl" in name.lower() and not name.startswith("nccl:"))
            or "onerank" in name.lower()]


def phase_nccl(dev, click_json, ultra_dir, base):
    """NCCL at world size 1: the backend resolves to NCCL, torch.profiler
    records NCCL's kernel, and a DLA window through the group equals the
    same window without one, bit for bit."""
    from ultra_pytorch_tpu_torch.parallel import (
        close_data_parallel, init_data_parallel)

    settings = dla_settings(True, click_json)
    plain, plain_metrics, _, _ = dp_window_run(settings, ultra_dir, "unused",
                                               dev, 1)
    backend = init_data_parallel(
        1, 0, dev, init_method=f"file://{os.path.join(base, 'nccl_store')}")
    result = {}
    try:
        check(backend == "nccl", f"the backend on CUDA resolved to {backend}")

        def window():
            result["run"] = dp_window_run(settings, ultra_dir, "unused", dev,
                                          1)

        events = device_events(window)
    finally:
        close_data_parallel()
    exp, metrics, _, _ = result["run"]
    nccl = sorted(set(nccl_kernels(events)))
    print(f"[dp nccl] world size 1 on {backend}: data parallel "
          f"{exp.data_parallel}; NCCL kernels seen by torch.profiler: "
          f"{[n[:80] for n in nccl]}; loss {metrics[0]['loss']:.6f} vs "
          f"{plain_metrics[0]['loss']:.6f} without a group", flush=True)
    check(exp.data_parallel and exp.world_size == 1,
          "the world-size-1 Experiment is not a rank")
    if not nccl:
        print("[dp nccl] device activities seen: " + "; ".join(
            sorted({name[:60] for name, _ in events})[:60]), flush=True)
    check(nccl, "torch.profiler recorded no NCCL kernel")
    same = all(np.array_equal(a, b) for a, b in zip(
        exp.algorithm.state_leaves(exp.state),
        plain.algorithm.state_leaves(plain.state)))
    check(metrics == plain_metrics and same, "the NCCL window differs from "
          "the window without a group")


# -- phase 19: fused windows -------------------------------------------------
# The offline configs of configs/ whose train feed can plan, so on the card
# each window is one replayed CUDA graph (run/window.py): name -> settings
# with every kernel hparam its path allows, at phase 7's protocol.
FUSED_ALGOS = {"naive": "NaiveAlgorithm", "ipw_rank": "IPWrank",
               "regression_EM": "RegressionEM",
               "pairwise_debias": "PairDebias", "lambda_rank": "LambdaRank",
               "prs_rank": "PRSrank"}
# The configs whose queries/s phase 19 measures in turns and whose graph
# window it profiles.
FUSED_RATES = ("dla", "pairwise_debias", "dla_setrank", "dla_dlcm")
# Configs whose graph window may differ from the eager one within
# CAPTURE_TOL relative, with the library op that picks another algorithm
# under capture; every other config must match bit for bit.
CAPTURE_DIFFERS = {}
CAPTURE_TOL = 1e-6


def fused_settings(name: str, kernels: bool, click_json: str):
    """Phase 7's settings for the offline config `name` of configs/."""
    if name == "dla":
        return dla_settings(kernels, click_json)
    if name in RANKER_CONFIGS:
        return ranker_settings(name, kernels)
    settings = offline_settings(FUSED_ALGOS.get(name, "NaiveAlgorithm"),
                                kernels, click_json)
    if name == "naive_oracle":
        settings["train_input_hparams"] = "oracle_mode=true"
    return settings


def window_launches(settings, steps: int, windows: int):
    """The exact training launches of `windows` windows of `steps` steps
    in all (the feed's click-rate estimate left out): phase 7's, 11's and
    14's per-step formulas."""
    algo = settings["learning_algorithm"]
    dnn = settings["ranking_model"] == "DNN"
    fused = "fused_softmax_loss" in settings["learning_algorithm_hparams"]
    feed = settings["train_input_hparams"]
    clicks = "use_pallas_click=true" in feed and "oracle_mode" not in feed
    losses = (2 if algo == "DLA" else 1) * steps if fused else 0
    return {"K1": (2 if algo == "RegressionEM" else 1) * steps if dnn
            else 0, "K2": steps if dnn else 0, "K3": losses, "K4": losses,
            "K5": windows if clicks else 0}


def fused_run(settings, dev, data, fuse: bool, windows: int = 2, dp=None):
    """`windows` windows of WINDOW steps from seed 0, graph or eager (a rank
    of this process's group, if it has one, unless `dp` is "off"); the
    launches are counted from after the feed is built. Returns the
    experiment, the window metrics, each window's host seconds and the
    launches."""
    from ultra_pytorch_tpu_torch.run.experiment import Experiment

    exp = Experiment(settings, "unused", os.path.join(WORK, "fused"),
                     batch_size=BATCH, seed=0, device=dev, dp=dp)
    exp.setup(datasets=data)
    exp.init_state()
    reset_counts()
    metrics, seconds = [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(exp.train_steps(WINDOW, fuse))   # ends with a read
        seconds.append(time.perf_counter() - t0)
    return exp, metrics, seconds, read_counts()


def max_leaf_diff(a_leaves, b_leaves) -> float:
    """The largest difference between two lists of arrays, relative to
    each array's largest magnitude."""
    worst = 0.0
    for a, b in zip(a_leaves, b_leaves):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
        worst = max(worst, float(np.abs(a - b).max(initial=0.0)) / scale)
    return worst


def fused_against_eager(name: str, dev, data, click_json):
    """One config: two eager windows against two graph windows from the
    same state and data key (state, optimizer and aux leaves, the data key
    and the window metrics bit for bit, or within CAPTURE_TOL where
    CAPTURE_DIFFERS names the op), the graph's launches exact, then the
    graph validation pass against the eager one. Returns the graph run's
    launches (training and validation) and its experiment."""
    settings = fused_settings(name, True, click_json)
    eager, eager_metrics, _, _ = fused_run(settings, dev, data, False)
    graph, graph_metrics, _, counts = fused_run(settings, dev, data, True)
    check(graph.eager_reason() is None, f"{name}: its window is not "
          f"captured ({graph.eager_reason()})")
    want = window_launches(settings, 2 * WINDOW, 2)
    check(counts == want, f"{name}: the graph windows launched {counts}, "
          f"expected {want}")
    a = graph.algorithm.state_leaves(graph.state) + [graph._data_key]
    b = eager.algorithm.state_leaves(eager.state) + [eager._data_key]
    same = (len(a) == len(b) and all(np.array_equal(x, y)
                                     for x, y in zip(a, b))
            and graph_metrics == eager_metrics)
    diff = max(max_leaf_diff(a, b), max(
        abs(g[k] - e[k]) / max(abs(e[k]), 1e-30)
        for g, e in zip(graph_metrics, eager_metrics) for k in e))
    check(same or (name in CAPTURE_DIFFERS and diff <= CAPTURE_TOL),
          f"{name}: the graph window differs from the eager one (max rel "
          f"{diff:.3e})")
    reset_counts()
    keys, replayed = graph.validate_device("valid")
    valid_counts = read_counts()
    direct = graph._validation_pass("valid", graph._eval_generator())
    batches = math.ceil(data["valid"].num_queries / BATCH)
    dnn = settings["ranking_model"] == "DNN"
    check(torch.equal(replayed, direct), f"{name}: the graph validation "
          "pass differs from the eager one")
    check(valid_counts["K1"] == (batches if dnn else 0),
          f"{name}: the validation graph launched K1 {valid_counts['K1']} "
          f"times, expected {batches if dnn else 0}")
    print(f"[fused] {name}: 2 x {WINDOW} steps, graph "
          f"{'=' if same else '~'} eager (state, optimizer, aux, data key, "
          f"metrics; max rel diff {diff:.3e}); launches {counts}; losses "
          f"{fmt([m['loss'] for m in graph_metrics])}; validation graph = "
          f"eager ({len(keys)} metrics, K1 {valid_counts['K1']})",
          flush=True)
    for k, n in valid_counts.items():
        counts[k] += n
    return counts, graph


def fused_rates(name: str, dev, data, click_json):
    """Queries/s of window 2 (the first is the capture or the warm-up) in
    turns graph, eager, eager, graph, then the plain path graph and eager;
    the graph run's step time and torch.profiler's busy and idle share of
    a graph window."""
    rates, graph_exp, graph_secs = {}, None, []
    for fuse, kernels in ((True, True), (False, True), (False, True),
                          (True, True), (True, False), (False, False)):
        exp, _, seconds, _ = fused_run(fused_settings(name, kernels,
                                                      click_json),
                                       dev, data, fuse)
        key = ("graph" if fuse else "eager") + ("" if kernels else " plain")
        rates.setdefault(key, []).append(WINDOW * BATCH / seconds[-1])
        if fuse and kernels:
            graph_exp = exp
            graph_secs.append(seconds[-1])
    print(f"[fused rates] {name} queries/s of window 2 on {card_line()} "
          f"(turns graph, eager, eager, graph; then plain graph, plain "
          f"eager): " + json.dumps({k: [round(x) for x in v]
                                    for k, v in rates.items()}), flush=True)
    step_wall = sum(graph_secs) / len(graph_secs) / WINDOW
    profile_steps(graph_exp, f"[fused profile {name}]", step_wall,
                  fuse_window=True)
    return rates


def fused_validation_long(dev, click_json):
    """The validation graph at phase 17's shape: DLA at full width on
    lists of FORMAT_DOCS documents, so a batch is 30,720 rows through K1;
    the replayed pass equals the eager one bit for bit, twice."""
    from ultra_pytorch_tpu_torch.run.experiment import Experiment

    data = {"train": synthetic(1024, 30),
            "valid": synthetic(512, 31, FORMAT_DOCS)}
    exp = Experiment(dla_settings(True, click_json), "unused",
                     os.path.join(WORK, "fused"), batch_size=BATCH, seed=0,
                     device=dev)
    exp.setup(datasets=data)
    exp.init_state()
    reset_counts()
    first = exp.validate_device("valid")[1]
    again = exp.validate_device("valid")[1]
    counts = read_counts()
    direct = exp._validation_pass("valid", exp._eval_generator())
    batches = math.ceil(512 / BATCH)
    check(torch.equal(first, direct) and torch.equal(again, direct),
          "the 30,720-row validation graph differs from the eager pass")
    check(counts["K1"] == 2 * batches, f"the 30,720-row validation graph "
          f"launched K1 {counts['K1']} times in two replays, expected "
          f"{2 * batches}")
    print(f"[fused] validation at {BATCH} x {FORMAT_DOCS} rows a batch: "
          f"graph = eager over two replays; K1 {counts['K1']}", flush=True)
    return counts


def fused_cli(data_dir: str, settings, tag: str, want):
    """`settings` through the CLI on phase 8's data (in this process),
    pipelined and with ``--sync_readback``: 2 windows and a tail, so two
    graphs. The step lines without their rates, the validation metrics and
    the saved checkpoints must be equal, and each run's launches exactly
    `want`. Returns both runs' launches, summed."""
    from ultra_pytorch_tpu_torch.utils import checkpoint as ckpt_lib

    stem = os.path.join(WORK, tag.replace(" ", "_"))
    setting_file = f"{stem}_settings.json"
    with open(setting_file, "w") as fout:
        json.dump(settings, fout)
    steps = 2 * WINDOW + WINDOW // 2
    lines, ckpts, total = {}, {}, dict.fromkeys(counters(), 0)
    for mode, extra in (("pipelined", []), ("sync", ["--sync_readback"])):
        model_dir = f"{stem}_{mode}"
        shutil.rmtree(model_dir, ignore_errors=True)
        reset_counts()
        out = run_cli_here(f"{tag} {mode}", [
            "--data_dir", data_dir, "--setting_file", setting_file,
            "--model_dir", model_dir, "--batch_size", str(BATCH),
            "--max_train_iteration", str(steps),
            "--steps_per_checkpoint", str(WINDOW)] + extra)
        counts = read_counts()
        check(counts == want, f"the {mode} CLI launched {counts}, expected "
              f"{want}")
        check("Training windows: captured CUDA graphs" in out,
              f"the {mode} CLI did not capture its windows")
        for k, n in counts.items():
            total[k] += n
        lines[mode] = [re.sub(r"\(\d+ queries/s\)", "", line)
                       for line in out.splitlines() if line.startswith(
                           ("step ", "  saved", "Training done"))]
        name = settings["learning_algorithm"].rsplit(".", 1)[-1]
        path = os.path.join(model_dir, f"{name}.ckpt")
        meta = ckpt_lib.read_metadata(path)
        with np.load(path + ".npz") as arrays:
            ckpts[mode] = (meta.get("step"),
                           {k: arrays[k] for k in arrays.files})
    check(lines["pipelined"] == lines["sync"], "the pipelined and the "
          "--sync_readback CLI printed different metrics")
    (step_a, a), (step_b, b) = ckpts["pipelined"], ckpts["sync"]
    check(step_a == step_b and a.keys() == b.keys()
          and all(np.array_equal(a[k], b[k]) for k in a),
          "the pipelined and the --sync_readback CLI saved different "
          "checkpoints")
    print(f"[{tag}] pipelined = --sync_readback: {len(lines['sync'])} "
          f"lines, checkpoint of step {step_a} equal ({len(a)} arrays); "
          f"launches each {want}", flush=True)
    return total


def phase_fused(dev, click_json, data, data_dir):
    """Phase 19: every offline config's window as a replayed CUDA graph
    against the eager window, the validation graph (also at 30,720 rows a
    batch), queries/s in turns with the graph window's idle share for
    FUSED_RATES, and the CLI pipelined against ``--sync_readback``.
    Returns the graph runs' launches, summed."""
    t0 = time.perf_counter()
    total = dict.fromkeys(counters(), 0)
    for name in ("dla", *FUSED_ALGOS, "naive_oracle", *RANKER_CONFIGS):
        counts, _ = fused_against_eager(name, dev, data, click_json)
        for k, n in counts.items():
            total[k] += n
    cli = fused_cli(data_dir, dla_settings(True, click_json), "fused cli",
                    cli_launches(2 * WINDOW + WINDOW // 2, 3, 128))
    for part in (fused_validation_long(dev, click_json), cli):
        for k, n in part.items():
            total[k] += n
    for name in FUSED_RATES:
        fused_rates(name, dev, data, click_json)
    print(f"[fused] phase 19 in {time.perf_counter() - t0:.1f} s", flush=True)
    return total


# -- phase 20: the online family's fused windows -----------------------------
# The online configs whose eager and graph windows phase 20 profiles.
ONLINE_PROFILED = ("mgd", "nsgd")
# Phase 20's dynamic-bias run: eta grows by 0.5 every 30 steps, so each
# window of 50 steps crosses an interval.
ETA_HPARAMS = "dynamic_bias_eta_change=0.5,dynamic_bias_step_interval=30"


def run_leaves(exp):
    """The state (ranker, optimizer, aux) and the data key of a run."""
    return exp.algorithm.state_leaves(exp.state) + [exp._data_key]


def same_runs(a, b) -> bool:
    """Whether two (experiment, window metrics) runs ended bit for bit
    alike: state, optimizer, aux, data key and window metrics."""
    la, lb = run_leaves(a[0]), run_leaves(b[0])
    return (len(la) == len(lb) and a[1] == b[1]
            and all(np.array_equal(x, y) for x, y in zip(la, lb)))


def online_graph_turns(config: str, dev, data):
    """`config` 2 x WINDOW steps at full width in turns graph, eager from
    the same seed: the graph run equal to the eager run bit for bit, each
    run's launches exact (the graph's through its replays), queries/s of
    window 2; for ONLINE_PROFILED each way's ms a step, busy ms, idle
    share and device-to-host copies from a profiled window. Returns a
    run's launches, the rates and the profiles."""
    settings = online_settings(config, True)
    want = online_launches(config, 2 * WINDOW, 0)
    runs = {True: [], False: []}
    for fuse in (True, False):
        exp, metrics, seconds, counts = fused_run(settings, dev, data, fuse)
        check(counts == want, f"{config}: the {'graph' if fuse else 'eager'}"
              f" windows launched {counts}, expected {want}")
        check(all(math.isfinite(v) for m in metrics for v in m.values()),
              f"{config}: non-finite window metrics")
        if fuse:
            check(exp.eager_reason() is None, f"{config}: its window is not "
                  f"captured ({exp.eager_reason()})")
        runs[fuse].append((exp, metrics, seconds))
    same = all(same_runs(g, e) for g, e in zip(runs[True], runs[False]))
    check(same, f"{config}: the graph windows differ from the eager ones")
    rates = {("graph" if fuse else "eager"): [WINDOW * BATCH / r[2][-1]
                                              for r in runs[fuse]]
             for fuse in (True, False)}
    print(f"[online fused] {config}: 2 x {WINDOW} steps, graph = eager "
          f"(state, optimizer, aux, data key, metrics); "
          f"launches {want} each run; losses "
          f"{fmt([m['loss'] for m in runs[True][0][1]])}; queries/s of "
          f"window 2 (turns graph, eager): "
          + json.dumps({k: [round(x) for x in v] for k, v in rates.items()}),
          flush=True)
    profiles = {}
    if config in ONLINE_PROFILED:
        for fuse in (False, True):
            way = "graph" if fuse else "eager"
            step_wall = (sum(r[2][-1] for r in runs[fuse])
                         / len(runs[fuse]) / WINDOW)
            profiles[way] = (1e3 * step_wall, profile_steps(
                runs[fuse][0][0], f"[online profile {config} {way}]",
                step_wall, fuse_window=fuse))
        graph_profile = profiles["graph"][1]
        if graph_profile is not None:
            check(graph_profile[2] <= 1, f"{config}: a replayed window "
                  f"copied {graph_profile[2]} times to the host (one is the "
                  "window's metrics)")
    return want, rates, profiles


def online_eta_run(dev, data):
    """``naive_online`` under ETA_HPARAMS: two graph windows equal two
    eager windows bit for bit across the eta's intervals (a replay that
    kept the captured step's eta would not), and differ from the graph
    run without the schedule. Returns the graph run's launches."""
    plain = online_settings("naive_online", True)
    settings = dict(plain, train_input_hparams=(
        plain["train_input_hparams"] + "," + ETA_HPARAMS))
    graph = fused_run(settings, dev, data, True)
    eager = fused_run(settings, dev, data, False)
    still = fused_run(plain, dev, data, True)
    same = same_runs(graph, eager)
    moved = graph[1] != still[1]
    print(f"[online fused] naive_online with {ETA_HPARAMS}: graph = eager "
          f"{same} over steps 0-{2 * WINDOW - 1}; window metrics differ from "
          f"the fixed-eta graph run {moved}; losses "
          f"{fmt([m['loss'] for m in graph[1]])} against "
          f"{fmt([m['loss'] for m in still[1]])}", flush=True)
    check(same, "the dynamic-bias graph windows differ from the eager ones")
    check(moved, "the dynamic-bias schedule did not change the clicks")
    return graph[3]


def phase_online_fused(dev, data, data_dir):
    """Phase 20: each online config's windows as replayed CUDA graphs
    against eager windows (ONLINE_LIST candidates), the dynamic-bias run,
    and ONLINE_CLI through the CLI pipelined against ``--sync_readback``.
    Returns the graph runs' launches, summed."""
    t0 = time.perf_counter()
    total = dict.fromkeys(counters(), 0)
    summary = {}
    for config in ONLINE:
        counts, rates, profiles = online_graph_turns(config, dev, data)
        for k, n in counts.items():
            total[k] += 2 * n
        summary[config] = rates
        for way, (ms, prof) in profiles.items():
            if prof is not None:
                print(f"[online fused] {config} {way}: {ms:.4f} ms a step, "
                      f"busy {prof[0]:.4f} ms, idle {100 * prof[1]:.1f}%, "
                      f"{prof[2]} device-to-host copies in a window, "
                      f"{BATCH / ms * 1e3:.0f} queries/s on {card_line()}",
                      flush=True)
    parts = [online_eta_run(dev, data)]
    steps, windows = 2 * WINDOW + WINDOW // 2, 3
    for config in ONLINE_CLI:
        want = online_launches(config, steps, windows * math.ceil(
            128 / BATCH))
        parts.append(fused_cli(data_dir, online_settings(config, True),
                               f"online fused cli {config}", want))
    for part in parts:
        for k, n in part.items():
            total[k] += n
    print(f"[online fused] queries/s of window 2 on {card_line()}: "
          + json.dumps({c: {k: [round(x) for x in v] for k, v in r.items()}
                        for c, r in summary.items()}), flush=True)
    print(f"[online fused] phase 20 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return total


# -- phase 21: the offline pipeline and the convergence study ----------------
# The pipeline's generated libsvm data (the convergence generator's, at a
# smaller size) and its training: DLA with every kernel on, 2 windows.
PIPELINE_DATA = {"train_queries": 512, "valid_queries": 128,
                 "test_queries": 128}
PIPELINE_STEPS = 2 * WINDOW


def phase_pipeline(click_json) -> None:
    """Phase 21 (a): ``example/torch_dataset_pipeline.sh`` at
    ``DEVICE=cuda`` on generated libsvm data: clean, normalize, sample, the
    port's initial ranker on the card (and its re-prediction of the full
    train file), ULTRA prep, DLA with every kernel on for 2 windows through
    the CLI as captured CUDA graphs, ``--test_only``; the ranker's files
    and the ranklist checked. Then the ranker's optax Adagrad step on fixed
    pairs on the card against the CPU."""
    import torch_convergence as conv
    from ultra_pytorch_tpu_torch.pipeline import initial_ranking as ir

    t0 = time.perf_counter()
    base = os.path.join(WORK, "pipeline")
    shutil.rmtree(base, ignore_errors=True)
    gen_dir, raw, work = (os.path.join(base, d) for d in ("gen", "raw",
                                                          "work"))
    conv.generate(gen_dir, **PIPELINE_DATA)
    os.makedirs(raw)
    for src, dst in (("train", "train"), ("valid", "vali"),
                     ("test", "test")):
        shutil.copy(os.path.join(gen_dir, src, f"{src}.txt"),
                    os.path.join(raw, f"{dst}.txt"))
    setting_file = os.path.join(base, "dla_settings.json")
    with open(setting_file, "w") as fout:
        json.dump(dla_settings(True, click_json), fout)
    env = dict(os.environ, PYTHONPATH=ROOT, DATA_PATH=raw, WORK=work,
               FEATURES=str(FEATURES), SETTING=setting_file,
               MAX_ITER=str(PIPELINE_STEPS), BATCH=str(BATCH), DEVICE="cuda")
    proc = subprocess.run(
        ["bash", os.path.join(ROOT, "example", "torch_dataset_pipeline.sh")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        print(f"[pipeline] {line}", flush=True)
    check(proc.returncode == 0, "the port's pipeline failed:\n"
          + proc.stderr[-3000:])
    check("Training windows: captured CUDA graphs" in proc.stdout,
          "the pipeline's training did not run as CUDA graphs")
    with np.load(os.path.join(work, "rank", "model.npz")) as model:
        w, b = model["w"], model["b"]
    check(w.dtype == np.float32 and w.shape == (FEATURES,)
          and bool(np.isfinite(w).all()) and b.shape == ()
          and b.dtype == np.float64,
          "the initial ranker's model.npz is not w float32 [F], b 0-d")
    for split in ("train", "valid", "test"):
        with open(os.path.join(work, "normalized", f"{split}.txt")) as fin:
            rows = sum(1 for _ in fin)
        scores = np.loadtxt(os.path.join(work, "rank", f"{split}.predict"),
                            ndmin=1)
        check(len(scores) == rows and bool(np.isfinite(scores).all()),
              f"{split}.predict is not one finite score a row")
    with open(os.path.join(work, "out", "test.ranklist")) as fin:
        lines = fin.read().splitlines()
    with open(os.path.join(work, "normalized", "test.txt")) as fin:
        docs = sum(1 for _ in fin)
    check(len(lines) == docs and all(len(x.split()) == 6 for x in lines),
          "the pipeline's ranklist is not one TREC line per test document")
    # The ranker's step on fixed pairs: the card against the CPU.
    rng = np.random.default_rng(21)
    x = rng.normal(size=(512, FEATURES)).astype(np.float32)
    y = rng.integers(0, 5, size=512).astype(np.float32)
    gid = np.repeat(np.arange(32), 16).astype(np.int32)
    pairs = [(torch.from_numpy(rng.integers(0, 512, ir.PAIRS)),
              torch.from_numpy(rng.integers(0, 512, ir.PAIRS)))
             for _ in range(5)]
    params = {}
    for d in ("cpu", "cuda"):
        w_t = torch.zeros(FEATURES, device=d, requires_grad=True)
        b_t = torch.zeros((), device=d, requires_grad=True)
        accs = [torch.full_like(w_t, ir.ACCUMULATOR_INIT),
                torch.full_like(b_t, ir.ACCUMULATOR_INIT)]
        xd, yd, gd = (torch.from_numpy(a).to(d) for a in (x, y, gid))
        for ii, jj in pairs:
            loss = ir.pairwise_loss(w_t, b_t, xd, yd, gd, ii.to(d), jj.to(d))
            ir.adagrad_update([w_t, b_t], torch.autograd.grad(
                loss, [w_t, b_t]), accs)
        params[d] = w_t.detach().cpu()
    err = (params["cuda"] - params["cpu"]).abs().max().item()
    print(f"[pipeline] initial ranker: 5 Adagrad steps on fixed pairs, card "
          f"vs CPU max abs err {err:.3e} (limit 1e-6); ranklist "
          f"{len(lines)} lines; phase 21 (a) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(err <= 1e-6, "the initial ranker's step differs on the card")


def convergence_launches(name: str, steps: int, valid_batches: int):
    """The exact launches of one convergence run: training by phases 19's
    and 20's formulas, K5's click-rate estimate, and K1 once a validation
    batch of every pass (step 0 and every eval_every steps)."""
    import torch_convergence as conv

    passes = steps // conv.PROTOCOL["eval_every"] + 1
    if name in conv.ONLINE:
        return online_launches(conv.ALGORITHMS[name][0], steps,
                               passes * valid_batches)
    settings = conv.settings(name, conv.PROTOCOL["hidden"], True)
    for key in ("ranking_model", "learning_algorithm"):   # registry names
        settings[key] = settings[key].rsplit(".", 1)[-1]
    want = window_launches(settings, steps,
                           steps // conv.PROTOCOL["eval_every"])
    want["K1"] += passes * valid_batches
    want["K5"] += 1
    return want


def phase_convergence(dev):
    """Phase 21 (b): the convergence study at the full protocol
    (``torch_convergence.study``) against the JAX package's runs in
    ``tests/torch_convergence_expected.json``: the generated files' sha256s
    equal the fixture's; each algorithm trained for each seed as replayed
    CUDA graph windows with K1-K5 on, the study's launches exact; one line
    a run and one an algorithm, and any algorithm outside its band fails
    the run. Returns the launches."""
    import torch_convergence as conv

    t0 = time.perf_counter()
    with open(conv.EXPECTED) as fin:
        expected = json.load(fin)
    data_dir = os.path.join(WORK, "convergence", "data")
    generated = conv.generate(data_dir, **expected["generator"]["args"])
    differ = conv.check_files(generated, expected)
    check(not differ, f"the generated files differ from the fixture's: "
          f"{differ}")
    print(f"[convergence] data: {len(generated['files'])} files, "
          f"{sum(f['bytes'] for f in generated['files'].values())} bytes, "
          f"sha256 as the fixture's; initial list nDCG@10 "
          f"{generated['initial_ndcg_10']}", flush=True)
    reset_counts()
    results = conv.study(data_dir, expected, list(conv.ALGORITHMS),
                         conv.PROTOCOL["seeds"], dev,
                         log=lambda line: print(line, flush=True))
    counts = read_counts()
    valid_batches = math.ceil(generated["args"]["valid_queries"]
                              / conv.PROTOCOL["batch"])
    want = dict.fromkeys(counts, 0)
    for name, (_, steps) in conv.ALGORITHMS.items():
        for k, n in convergence_launches(name, steps, valid_batches).items():
            want[k] += n * conv.PROTOCOL["seeds"]
    print(f"[convergence] phase 21 (b) in {time.perf_counter() - t0:.1f} s "
          f"on {card_line()}; launches {counts}", flush=True)
    check(counts == want, f"the study launched {counts}, expected {want}")
    eager = [name for name, r in results.items()
             if any(run["windows"] != "graphs" for run in r["runs"])]
    check(not eager, f"windows ran eager for {eager}")
    failed = [name for name, r in results.items() if not r["verdict"]["ok"]]
    check(not failed, f"outside the JAX band or below the gain: {failed}")
    return counts


# -- phase 22: the data-parallel window and the serving bucket as graphs -----
# The configs whose data-parallel windows phase 22 holds graph against
# eager at NCCL world size 1: DLA with K1-K5, Regression-EM (its uniforms
# from the shard generator), PairDebias, and PDGD, MGD and NSGD (their
# noises from the replica generator).
DP_GRAPH = ("dla", "regression_EM", "pairwise_debias", "pdgd", "mgd", "nsgd")
# Phase 14's config of each ranker, served from its checkpoint: every
# bucket up to SERVE_MAX and SERVE_LONG (a 1,000-document list), graph
# against the eager body; SERVE_SHRINK shrinks inside one bucket.
SERVE_RANKERS = {"DNN": "dla_ubm", "Linear": "naive_linear",
                 "SetRank": "dla_setrank", "DLCM": "dla_dlcm",
                 "GSF": "naive_gsf"}
SERVE_MAX = (256, 128)
SERVE_LONG = (3, 1000)
SERVE_SHRINK = ((64, 128), (50, 100), (33, 70), (40, 65), (17, 66))


def nccl_pair_rank(rank, world, init_method):
    """One of two NCCL ranks on cuda:0: an all-reduce's result, or what
    NCCL raised."""
    import torch.distributed as dist

    from ultra_pytorch_tpu_torch.parallel import (
        close_data_parallel, init_data_parallel)

    init_data_parallel(world, rank, torch.device("cuda", 0), backend="nccl",
                       init_method=init_method)
    try:
        x = torch.ones(4, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
    except Exception as exc:   # NCCL's refusal is the answer sought
        return (f"refused ({type(exc).__name__}: "
                + " ".join(str(exc).split())[:240] + ")")
    close_data_parallel()
    return f"an all-reduce ran: {x.tolist()}"


def dp_graph_configs(dev, click_json, data, online_data):
    """Each of DP_GRAPH: two graph windows against two eager ones
    (``fuse_window=False``) as a rank of this process's NCCL group of one,
    bit for bit, launches exact both ways; DLA's also against the graph
    windows without a group. Returns the graph runs' launches, summed,
    and DLA's graph run and settings."""
    total = dict.fromkeys(counters(), 0)
    dla = None
    for name in DP_GRAPH:
        online = name in ONLINE
        settings = (online_settings(name, True) if online
                    else fused_settings(name, True, click_json))
        run_data = online_data if online else data
        want = (online_launches(name, 2 * WINDOW, 0) if online
                else window_launches(settings, 2 * WINDOW, 2))
        graph = fused_run(settings, dev, run_data, True)
        eager = fused_run(settings, dev, run_data, False)
        exp = graph[0]
        check(exp.data_parallel and exp.world_size == 1
              and eager[0].data_parallel,
              f"{name}: the run is not a rank of the NCCL group")
        check(exp.eager_reason() is None, f"{name}: its data-parallel "
              f"window is not captured ({exp.eager_reason()})")
        check(graph[3] == want and eager[3] == want, f"{name}: launches "
              f"graph {graph[3]}, eager {eager[3]}, expected {want}")
        check(same_runs(graph, eager), f"{name}: the data-parallel graph "
              "windows differ from the eager ones")
        line = (f"[dp graph] {name}: 2 x {WINDOW} steps at NCCL world size "
                f"1, graph = eager (state, optimizer, aux, data key, "
                f"metrics); launches {graph[3]} both ways; losses "
                f"{fmt([m['loss'] for m in graph[1]])}")
        if name == "dla":
            solo = fused_run(settings, dev, run_data, True, dp="off")
            check(not solo[0].data_parallel, "the dp=off run is a rank")
            check(same_runs(graph, solo), "DLA's data-parallel graph "
                  "windows differ from its graph windows without a group")
            line += "; = the graph windows without a group"
            dla = (exp, settings)
        print(line, flush=True)
        for k, n in graph[3].items():
            total[k] += n
    return total, dla


def dp_graph_rates(dev, data, dla):
    """NCCL's kernel inside a replayed DLA window; queries/s of window 2 in
    turns (graph, eager, eager, graph, each beside a graph run without a
    group); torch.profiler's busy and idle share of a data-parallel graph
    window and of one without a group."""
    exp, settings = dla
    events = device_events(lambda: exp.train_steps(WINDOW))
    nccl = nccl_kernels(events)
    print(f"[dp graph] a replayed DLA window of {WINDOW} steps: "
          f"{len(nccl)} NCCL kernels seen by torch.profiler "
          f"({sorted({n[:60] for n in nccl})}), {len(events)} device "
          "activities", flush=True)
    check(nccl, "torch.profiler saw no NCCL kernel inside a replay")
    rates, last = {}, {}
    for key, fuse, dp in (("no group", True, "off"), ("graph", True, None),
                          ("eager", False, None), ("eager", False, None),
                          ("graph", True, None), ("no group", True, "off")):
        run = fused_run(settings, dev, data, fuse, dp=dp)
        rates.setdefault(key, []).append(WINDOW * BATCH / run[2][-1])
        last[key] = run
    print(f"[dp graph] DLA queries/s of window 2 on {card_line()} (turns "
          "graph, eager, eager, graph at NCCL world size 1; the graph "
          "without a group first and last): " + json.dumps(
              {k: [round(x) for x in v] for k, v in rates.items()}),
          flush=True)
    for key in ("graph", "no group", "eager"):
        run = last[key]
        step_wall = run[2][-1] / WINDOW
        profile_steps(run[0], f"[dp graph profile {key}]", step_wall,
                      fuse_window=key != "eager")


def phase_dp_graph(dev, click_json, data, online_data):
    """Phase 22 [dp graph]: data-parallel windows as CUDA graphs under
    NCCL at world size 1, then whether NCCL takes two ranks on cuda:0.
    Returns the graph runs' launches."""
    from ultra_pytorch_tpu_torch.parallel import (
        close_data_parallel, init_data_parallel, spawn_ranks)

    base = os.path.join(WORK, "dp_graph")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    backend = init_data_parallel(
        1, 0, dev, init_method=f"file://{os.path.join(base, 'store')}")
    try:
        check(backend == "nccl", f"the backend on CUDA resolved to {backend}")
        total, dla = dp_graph_configs(dev, click_json, data, online_data)
        dp_graph_rates(dev, data, dla)
    finally:
        close_data_parallel()
    try:
        answers = spawn_ranks(nccl_pair_rank, 2, (
            f"file://{os.path.join(base, 'pair_store')}",), timeout=90)
        said = "; ".join(f"rank {r}: {a}" for r, a in enumerate(answers))
    except RuntimeError as exc:
        said = "no answer (" + " ".join(str(exc).split())[:240] + ")"
    print(f"[dp graph] two NCCL ranks on cuda:0: {said}", flush=True)
    return total


def padded_reference(ranker, feats, n_valid, dev):
    """A request scored on a freshly zero-padded bucket, apart from the
    Scorer's buffers: its masked scores and compacted order."""
    from ultra_pytorch_tpu_torch.serve.scorer import _bucket

    q, length, _ = feats.shape
    bq, bl = _bucket(q, 8), _bucket(length, 8)
    x = np.zeros((bq, bl, FEATURES), np.float32)
    x[:q, :length] = feats
    n = np.zeros(bq, np.int64)
    n[:q] = n_valid
    with torch.inference_mode():
        mask = (torch.arange(bl, device=dev)[None, :]
                < torch.from_numpy(n).to(dev)[:, None])
        scores = ranker(torch.from_numpy(x).to(dev), mask)
        masked = torch.where(mask, scores, torch.full_like(scores, -1e30))
        order = torch.argsort(-masked, dim=1, stable=True)[:q].cpu().numpy()
    return (masked[:q, :length].cpu().numpy(),
            order[order < length].reshape(q, length))


def ragged(rng, q: int, length: int):
    """`q` lists of `length` full-width documents, each valid up to a
    random length (the first list full)."""
    feats = rng.normal(size=(q, length, FEATURES)).astype(np.float32)
    n_valid = rng.integers(1, length + 1, size=q).astype(np.int32)
    n_valid[0] = length
    return feats, n_valid


def serve_graph_ranker(ranker: str, config: str, dev, data):
    """One ranker from its checkpoint: every bucket up to SERVE_MAX and
    SERVE_LONG graph against the eager body (scores within TOL, orders
    equal), and SERVE_SHRINK inside one bucket against a freshly padded
    reference; the graph Scorer's calls launch K1 once each for the DNN,
    never for another ranker. Returns the graph and the eager Scorer and
    the graph Scorer's K1 launches."""
    from ultra_pytorch_tpu_torch.ops.kernels import mlp
    from ultra_pytorch_tpu_torch.run.experiment import Experiment
    from ultra_pytorch_tpu_torch.serve import Scorer

    counted = {"calls": 0, "K1": 0}

    def on_graph(fn, *args):
        before = mlp.fused_mlp_score.launches
        out = fn(*args)
        counted["K1"] += mlp.fused_mlp_score.launches - before
        return out

    model_dir = os.path.join(WORK, "serve_graph", config)
    shutil.rmtree(model_dir, ignore_errors=True)
    exp = Experiment(ranker_settings(config, True), "unused", model_dir,
                     batch_size=BATCH, seed=1, device=dev)
    exp.setup(datasets=data)
    exp.init_state()
    exp.save({"step": 0})
    graph = Scorer.from_checkpoint(model_dir, device=dev)
    eager = Scorer.from_checkpoint(model_dir, device=dev, graphs=False)
    check(type(graph.ranker).__name__ == ranker and graph.graphs
          and not eager.graphs, f"{config}: the Scorers are not as asked")
    t0 = time.perf_counter()
    on_graph(graph.warmup, *SERVE_MAX)
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    worst = 0.0
    requests = sorted(graph._ranked) + [SERVE_LONG]
    calls = len(requests) + len(requests) - 1 + len(SERVE_SHRINK)
    for q, length in requests:
        feats, n_valid = ragged(rng, q, length)
        s_graph, o_graph = on_graph(graph._score_ranked, feats, n_valid)
        s_eager, o_eager = eager._score_ranked(feats, n_valid)
        worst = max(worst, float(np.abs(s_graph - s_eager).max()))
        check(np.allclose(s_graph, s_eager, rtol=TOL, atol=TOL)
              and np.array_equal(o_graph, o_eager),
              f"{config}: bucket {q}x{length} replayed differs from its "
              "eager body")
    shrink = 0.0
    for q, length in SERVE_SHRINK:
        feats, n_valid = ragged(rng, q, length)
        s_graph, o_graph = on_graph(graph._score_ranked, feats, n_valid)
        s_ref, o_ref = padded_reference(graph.ranker, feats, n_valid, dev)
        shrink = max(shrink, float(np.abs(s_graph - s_ref).max()))
        check(np.allclose(s_graph, s_ref, rtol=TOL, atol=TOL)
              and np.array_equal(o_graph, o_ref),
              f"{config}: {q}x{length} after a larger request differs from "
              "a freshly padded bucket (stale padding)")
    want = calls if ranker == "DNN" else 0
    print(f"[serve graph] {ranker} ({config}): {len(graph._ranked)} bucket "
          f"graphs captured (warm-up {warm_s:.1f} s), {len(requests)} "
          f"requests graph = eager body (max abs diff {worst:.3e}, limit "
          f"rtol=atol={TOL}, orders equal); {len(SERVE_SHRINK)} shrinking "
          f"requests in one bucket = a freshly padded bucket (max abs diff "
          f"{shrink:.3e}); the graph Scorer's {calls} calls launched K1 "
          f"{counted['K1']} times", flush=True)
    check(counted["K1"] == want, f"{config}: the graph Scorer's {calls} "
          f"calls launched K1 {counted['K1']} times, expected {want}")
    return graph, eager, counted["K1"]


def serve_graph_timing(graph, eager):
    """The DNN's ``Scorer`` call at BUCKETS, graph against eager body in
    turns, and K1's device time inside a replay; K1 counted once a
    replayed call. Returns the K1 launches of the replayed calls. Run in
    a fresh process (``serve_replays``): late in a long one torch.profiler
    keeps only some of a session's device records."""
    rng = np.random.default_rng(8)
    launches = 0
    for q, docs in BUCKETS:
        feats = rng.normal(size=(q, docs, FEATURES)).astype(np.float32)
        times = {"graph": [], "eager": []}
        for key in ("graph", "eager", "eager", "graph"):
            times[key].append(scorer_ms(graph if key == "graph" else eager,
                                        feats))
        calls = 5
        reset_counts()
        events = device_events(lambda: [graph._score_ranked(feats, None)
                                        for _ in range(calls)])
        counted = read_counts()["K1"]
        launches += counted
        k1 = [us for name, us in events if "mlp_fwd" in name]
        if len(k1) < calls:
            seen = {}
            for name, _ in events:
                seen[name[:60]] = seen.get(name[:60], 0) + 1
            print(f"[serve graph] {q}x{docs}: torch.profiler saw {len(k1)} "
                  f"of {calls} K1 launches; device events seen by name: "
                  f"{seen}", flush=True)
        check(counted == calls, f"{q}x{docs}: {calls} replayed calls "
              f"counted K1 {counted} times")
        check(k1, f"{q}x{docs}: torch.profiler saw no K1 inside a replay")
        busy = sum(us for _, us in events) / 1e3 / calls
        print(f"[serve graph] {q}x{docs} on {card_line()}: Scorer call "
              f"(host clock) graph {fmt(times['graph'])} ms, eager body "
              f"{fmt(times['eager'])} ms (turns graph, eager, eager, graph); "
              f"inside a replay K1 {sum(k1) / 1e3 / len(k1):.4f} ms ("
              f"{len(k1)} of {calls} launches seen by torch.profiler), all "
              f"device activities {busy:.4f} ms a call", flush=True)
    return launches


def phase_serve_graph(dev, data):
    """Phase 22 [serve graph]: each ranker's buckets as CUDA graphs, the
    DNN's call times. Returns the K1 launches of the DNN's replays."""
    k1 = 0
    for ranker, config in SERVE_RANKERS.items():
        _, _, launched = serve_graph_ranker(ranker, config, dev, data)
        k1 += launched
        if ranker == "DNN":
            out = run_module("phase 22 child", "chip_smoke",
                             ["--serve-replays", config], timeout=300)
            k1 += json.loads(out.strip().splitlines()[-1])["launches"]
    return k1


def serve_replays(config: str) -> int:
    """The child of phase 22: the DNN's graph and eager ``Scorer`` on the
    checkpoint that ``serve_graph_ranker`` wrote for `config`, every
    bucket up to SERVE_MAX captured, then ``serve_graph_timing``. Prints
    its K1 launches as the last line."""
    from ultra_pytorch_tpu_torch.serve import Scorer

    dev = torch.device("cuda")
    phase_device()
    model_dir = os.path.join(WORK, "serve_graph", config)
    graph = Scorer.from_checkpoint(model_dir, device=dev)
    eager = Scorer.from_checkpoint(model_dir, device=dev, graphs=False)
    check(type(graph.ranker).__name__ == "DNN" and graph.graphs
          and not eager.graphs, f"{config}: the Scorers are not as asked")
    graph.warmup(*SERVE_MAX)
    print(json.dumps({"launches": serve_graph_timing(graph, eager)}),
          flush=True)
    return 0


def phase_graphs(dev, click_json, data, online_data):
    """Phase 22: returns its graph runs' launches."""
    t0 = time.perf_counter()
    total = phase_dp_graph(dev, click_json, data, online_data)
    t1 = time.perf_counter()
    reset_counts()
    total["K1"] += phase_serve_graph(dev, data)
    print(f"[graphs] phase 22 in {time.perf_counter() - t0:.1f} s ([dp "
          f"graph] {t1 - t0:.1f} s)", flush=True)
    return total


def profile_launches(steps: int, chunk: int = 25):
    """``profile_step --steps <steps> --kernels``'s launches: feed, train
    and full each a warm-up and steps // chunk timed chunks, eager and
    again as graphs, and the profiled full window; K5 once a plan of the
    feed and of the full window, and once for the fixed batch's plan."""
    windows = 4 * (steps // chunk) + 5
    return dla_launches(windows * chunk, windows)


def phase_tools():
    """Phase 23: the port's tools on the card, each checked; the training
    tools at the JAX default (the library path) and with ``--kernels``
    (K1-K5); returns their runs' launches."""
    from ultra_pytorch_tpu_torch.models.dnn import DNN

    t0 = time.perf_counter()
    counts = dict.fromkeys(counters(), 0)
    zero = dict.fromkeys(counters(), 0)
    # Both profile_step runs first: torch.profiler keeps every record
    # early in a process (section 7 of PERF.md).
    prof_steps, roof_steps, roof_chunk = 100, 200, 50
    tools = (("profile_step", ["--steps", str(prof_steps)]),
             ("profile_step", ["--steps", str(prof_steps), "--kernels"]),
             ("roofline", ["--steps", str(roof_steps)]),
             ("roofline", ["--steps", str(roof_steps), "--kernels"]),
             ("bench_serve", ["--iters", "50"]), ("bench_serve_http", []),
             ("bench_eval", ["--repeats", "3"]),
             ("bench_eval", ["--repeats", "3", "--kernels"]))
    results = []
    for lines in run_mains("tools", [(f"ultra_pytorch_tpu_torch.tools.{n}", a)
                                     for n, a in tools], timeout=600):
        results.append(json.loads(lines[-1]))
        add_launches(counts, results[-1]["launches"])
    prof, prof_k, roof, roof_k, serve, http, evals, evals_k = results
    for label, run in (("library path", prof), ("--kernels", prof_k)):
        for name in ("feed", "train", "full"):
            graph, eager = run[f"{name}_us"], run[f"{name}_eager_us"]
            check(0 < graph < eager, f"profile_step ({label}): {name} "
                  f"{graph} us a step as a graph against {eager} eager")
    roof_windows = roof_steps // roof_chunk
    for label, got, want in (
            ("profile_step", prof["launches"], zero),
            ("profile_step --kernels", prof_k["launches"],
             profile_launches(prof_steps)),
            ("roofline", roof["launches"], zero),
            ("roofline --kernels", roof_k["launches"],
             dla_launches((roof_windows + 1) * roof_chunk, roof_windows)),
            ("bench_eval", evals["launches"], zero)):
        check(got == want, f"{label} launched {got}, expected {want}")
    n = BATCH * LIST
    model = DNN(HIDDEN, FEATURES)
    k3, _, k4, _ = loss_work(BATCH, LIST)
    kernel_flops = (mlp_work(model, n)[0] + mlp_bwd_work(model, n)[0]
                    + 2 * (k3 + k4))
    products = sum(roof_k["products"].values())
    print(f"[tools] roofline: {roof_k['flops_per_step'] / 1e9:.4f} GFLOP a "
          f"step ({products / 1e9:.4f} of products, the kernels "
          f"{roof_k['kernel_flops_per_step'] / 1e9:.4f}), "
          f"{roof_k['step_time_us']:.2f} us a step, mfu {roof_k['mfu']:.4f}, "
          f"hfu {roof_k['hfu']:.4f}", flush=True)
    print(f"[tools] library path (JAX default) vs K1-K5 (--kernels), "
          f"allow_tf32 {prof['allow_tf32']} / {roof['allow_tf32']}: "
          f"profile_step full {prof['full_us']:.2f} vs "
          f"{prof_k['full_us']:.2f} us a graph step (feed "
          f"{prof['feed_us']:.2f} vs {prof_k['feed_us']:.2f}, train "
          f"{prof['train_us']:.2f} vs {prof_k['train_us']:.2f}), busy_share "
          f"{prof['busy_share']} vs {prof_k['busy_share']}; roofline "
          f"{roof['step_time_us']:.2f} vs {roof_k['step_time_us']:.2f} us a "
          f"step, mfu {roof['mfu']:.4f} vs {roof_k['mfu']:.4f}, "
          f"hbm_utilization {roof['hbm_utilization']:.5f} vs "
          f"{roof_k['hbm_utilization']:.5f}, hfu {roof['hfu']} vs "
          f"{roof_k['hfu']:.4f}", flush=True)
    check(roof_k["kernel_flops_per_step"] == kernel_flops,
          f"roofline counts {roof_k['kernel_flops_per_step']} kernel "
          f"operations a step, mlp_work + mlp_bwd_work + loss_work "
          f"{kernel_flops}")
    check(roof["flops_per_step"] == roof_k["flops_per_step"]
          and roof["bytes_per_step"] == roof_k["bytes_per_step"],
          "roofline counts the library path's step apart from the kernels'")
    check(roof["hfu"] is None and roof["kernel_flops_per_step"] is None,
          "roofline gives an hfu on the library path")
    check(abs(products / 3.59e9 - 1) <= 0.02,
          f"roofline: {products} products a step, not 3.59 GFLOP")
    for run in (roof, roof_k):
        check(0 < run["mfu"] <= 1.0, f"roofline: mfu {run['mfu']}")
    for bucket, c in serve["k1_vs_plain"].items():
        check(c["scores_close"] and c["order_violations"] == 0,
              f"bench_serve {bucket}: K1 against the plain path {c}")
    for row in http["results"]:
        check(row["errors"] == 0, f"bench_serve_http {row['mode']}: "
              f"{row['errors']} errors {row['error_samples']}")
    micro = http["results"][-1]
    check(micro["mode"] == "micro_batched"
          and micro["coalescing_factor"] > 1,
          f"bench_serve_http: coalescing factor {micro}")
    for run in (evals, evals_k):
        check(run["max_diff"] <= 1e-4,
              f"bench_eval: the ways differ by {run['max_diff']}")
    print(f"[tools] phase 23 in {time.perf_counter() - t0:.1f} s; "
          f"launches {counts}", flush=True)
    return counts


# -- phase 24: the multi-device entry points ---------------------------------
DEMO_FEATURES, DEMO_LIST = 220, 200   # the demo's table: Istella's width
DEMO_CUTOFF = 10                      # the demo's selection_bias_cutoff
DRYRUN_CASES = 18                     # __graft_entry__.py's table


def demo_batch(dev, features: int = DEMO_FEATURES, length: int = DEMO_LIST):
    """A fixed batch at the demo's table width and list length (or
    `features` and `length`): B lists of 200 documents of 220 features, a
    quarter cut to three quarters of the list, clicks at 0.3 and always
    on the first."""
    rng = np.random.default_rng(5)
    mask = np.ones((BATCH, length), np.float32)
    mask[: BATCH // 4, length * 3 // 4:] = 0.0
    clicks = (rng.random((BATCH, length)) < 0.3).astype(np.float32) * mask
    clicks[:, 0] = 1.0
    return {"features": torch.from_numpy(rng.normal(
        size=(BATCH, length, features)).astype(np.float32)).to(dev),
        "labels": torch.from_numpy(clicks).to(dev),
        "mask": torch.from_numpy(mask).to(dev)}


def demo_step(dev, cutoff: int):
    """(e) One DLA step on ``demo_batch`` with the demo's settings at
    `cutoff` (the demo's own is DEMO_CUTOFF), kernels on against the plain
    path, from the same initialisation: K1 and K2 over B x cutoff rows of
    220 features, K3 and K4 at [B, cutoff]."""
    from ultra_pytorch_tpu_torch.run.experiment import create_algorithm
    from ultra_pytorch_tpu_torch.tools.shard_data_demo import demo_settings

    batch = demo_batch(dev)
    out, launches = {}, None
    for kernels in (True, False):
        settings = demo_settings(DEMO_LIST, kernels=kernels)
        check(settings["selection_bias_cutoff"] == DEMO_CUTOFF,
              "the demo's cutoff moved")
        settings["selection_bias_cutoff"] = cutoff
        alg = create_algorithm(settings, DEMO_FEATURES, 4.0, dev)
        state = alg.init_state(torch.Generator().manual_seed(1))
        before = read_counts()
        losses = alg.losses(state, batch)
        grads = torch.autograd.grad(losses[0], alg.trainable(state))
        torch.cuda.synchronize()
        if kernels:
            launches = {k: n - before[k] for k, n in read_counts().items()}
        n = len(state.params.jax_leaves())
        out[kernels] = (losses[0].item(),
                        torch.cat([g.reshape(-1) for g in grads[:n]]),
                        torch.cat([g.reshape(-1) for g in grads[n:]]))
    (loss_k, rank_k, prop_k), (loss_p, rank_p, prop_p) = out[True], out[False]
    rank_err, rank_rel = max_rel_err(rank_k, rank_p)
    prop_err, prop_rel = max_rel_err(prop_k, prop_p)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    where = ("the demo's settings" if cutoff == DEMO_CUTOFF
             else "off the slice's paths")
    print(f"[multi-device] (e) DLA step at B {BATCH} x L {DEMO_LIST} x F "
          f"{DEMO_FEATURES}, cutoff {cutoff} ({where}: K1/K2 over "
          f"{BATCH * cutoff} x {DEMO_FEATURES} rows, K3/K4 at [{BATCH}, "
          f"{cutoff}]), kernels on vs plain: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel {rel:.2e}, limit {LOSS_TOL}); ranker gradient "
          f"max abs {rank_err:.3e} ({rank_rel:.3e} of its largest), "
          f"propensity gradient {prop_err:.3e} ({prop_rel:.3e}) (limit "
          f"{GRAD_TOL}); launches {launches}", flush=True)
    check(math.isfinite(loss_k) and rel <= LOSS_TOL,
          f"the DLA loss at cutoff {cutoff} differs between kernels and "
          "plain")
    check(rank_rel <= GRAD_TOL and prop_rel <= GRAD_TOL,
          f"the DLA gradients at cutoff {cutoff} differ between kernels "
          "and plain")
    check(launches == {"K1": 1, "K2": 1, "K3": 2, "K4": 2, "K5": 0},
          f"the DLA step at cutoff {cutoff} launched {launches}")


def demo_timing(dev, gen, cutoff: int, features: int = DEMO_FEATURES,
                names=("K1", "K2", "K3", "K4")):
    """The kernels `names` of K1-K4 at the demo's width (or `features`)
    with lists cut to `cutoff` (B x cutoff rows; [B, cutoff]), each held
    against its plain version: device time a call (``graph_ms``) of the
    kernel, its plain version and the library chain (none for K3/K4), and
    the bound."""
    from ultra_pytorch_tpu_torch.models.dnn import DNN
    from ultra_pytorch_tpu_torch.ops import losses
    from ultra_pytorch_tpu_torch.ops.kernels import listwise_loss as ll
    from ultra_pytorch_tpu_torch.ops.kernels import mlp

    n = BATCH * cutoff
    model = DNN(HIDDEN, features, generator=gen).to(dev)
    x = torch.randn(n, features, generator=gen).to(dev)
    g = torch.randn(n, generator=gen).to(dev)
    s, y, w, m = loss_inputs(BATCH, cutoff, gen, dev)
    _, stats = ll.listwise_loss_forward(s, y, w, m, return_stats=True)
    ref_stats = ll.listwise_loss_stats_reference(s, y, w, m)
    one = torch.tensor(1.0, device=dev)
    k3_ops, k3_bytes, k4_ops, k4_bytes = loss_work(BATCH, cutoff)
    def no_grad(fn):
        def call():
            with torch.no_grad():
                return fn()
        return call

    cases = {
        "K1": (no_grad(lambda: mlp.fused_mlp_score(model.layers, x)),
               no_grad(lambda: mlp.fused_mlp_score_reference(model.layers,
                                                             x)),
               no_grad(lambda: library_chain(model, x)), *mlp_work(model, n),
               PEAK_3XTF32, f"{n} x {features}"),
        "K2": (lambda: mlp.mlp_backward(model.layers, x, g, "elu", True),
               lambda: mlp.mlp_backward_reference(model.layers, x, g, "elu",
                                                  True),
               lambda: library_fwd_bwd(model, x, g), *mlp_bwd_work(model, n),
               PEAK_3XTF32, f"{n} x {features}"),
        "K3": (lambda: ll.listwise_loss_forward(s, y, w, m,
                                                return_stats=True),
               lambda: (losses.softmax_loss(s, y, w, m),
                        ll.listwise_loss_stats_reference(s, y, w, m)),
               None, k3_ops, k3_bytes, PEAK_F32, f"[{BATCH}, {cutoff}]"),
        "K4": (lambda: ll.listwise_loss_backward(s, y, w, m, one, stats),
               lambda: ll.listwise_loss_backward_reference(
                   s, y, w, m, one, ref_stats),
               None, k4_ops, k4_bytes, PEAK_F32, f"[{BATCH}, {cutoff}]"),
    }
    cases = {k: cases[k] for k in names}
    with torch.no_grad():
        got, ref = cases["K1"][0](), cases["K1"][1]()
        check(torch.allclose(got, ref, rtol=TOL, atol=TOL),
              "K1 at the demo's width disagrees with its plain version")
        dx, grads = cases["K2"][0]()
        ref_dx, ref_grads = cases["K2"][1]()
        k2_rel = max(max_rel_err(a, b)[1] for a, b in
                     zip([dx] + grads, [ref_dx] + ref_grads))
        check(k2_rel <= GRAD_TOL, f"K2 at the demo's width off by {k2_rel}")
        if "K3" in cases:
            loss = ll.listwise_loss_forward(s, y, w, m)
            check(abs(loss.item() - losses.softmax_loss(s, y, w, m).item())
                  <= LOSS_TOL * abs(loss.item()),
                  f"K3 at [{BATCH}, {cutoff}] differs")
            k4_err = max_rel_err(cases["K4"][0](), cases["K4"][1]())[1]
            check(k4_err <= LOSS_TOL, f"K4 at [{BATCH}, {cutoff}] off by "
                  f"{k4_err}")
    rows = {}
    for name, (fn, plain, lib, n_ops, n_bytes, peak, shape) in cases.items():
        b_ms, by = bound(n_ops, n_bytes, peak)
        calls = 10 if name in ("K1", "K2") else 50
        rows[name] = r = dict(
            shape=shape, ms=graph_ms(fn, calls), plain_ms=graph_ms(plain, 5),
            library_ms=None if lib is None else graph_ms(lib, calls),
            bound_ms=b_ms, bound_by=by)
        lib_text = ("none" if lib is None
                    else f"{r['library_ms']:.4f} ms")
        print(f"[timing F {features}] {name} {shape}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib_text} (device time a call) | {n_ops / 1e9:.4f} GFLOP, "
              f"{n_bytes / 1e6:.3f} MB | bound {b_ms:.5f} ms ({by}), kernel "
              f"at {100 * b_ms / r['ms']:.2f}% of it", flush=True)
    return rows


def add_launches(total, part) -> None:
    for k, n in part.items():
        total[k] += n


def phase_multi_device(dev, gen):
    """Phase 24: the JAX system's multi-device entry points over the port.
    Returns the main paths' launches and the kernels' timing at the demo's
    widths."""
    from ultra_pytorch_tpu_torch.ops.kernels import mlp
    from ultra_pytorch_tpu_torch.run import dryrun
    from ultra_pytorch_tpu_torch.run.launch import shared_card
    from ultra_pytorch_tpu_torch.tools import bench_scaling, shard_data_demo

    t0 = time.perf_counter()
    counts = dict.fromkeys(counters(), 0)

    # (a) The flagship forward: one K1 launch over [8, 10, 136].
    fn, (ranker, feats, mask) = dryrun.entry()
    before = read_counts()["K1"]
    scores = fn(ranker, feats, mask)
    torch.cuda.synchronize()
    k1 = read_counts()["K1"] - before
    counts["K1"] += k1
    with torch.no_grad():
        ref = mlp.fused_mlp_score_reference(ranker.layers, feats)
    err = (scores - ref).abs().max().item()
    print(f"[multi-device] (a) entry(): scores {tuple(scores.shape)}, K1 "
          f"launches {k1}, max abs err against the plain version {err:.3e} "
          f"(limit rtol=atol={TOL})", flush=True)
    check(scores.shape == (8, 10) and k1 == 1
          and torch.allclose(scores, ref, rtol=TOL, atol=TOL),
          "entry(): K1 disagrees with its plain version")

    # (b) The dry run: NCCL at world size 1, then two gloo ranks on cuda:0.
    for label, group in (("NCCL, 1 rank", (1, dev, None)),
                         ("gloo, 2 ranks on cuda:0", shared_card(2, dev))):
        t1 = time.perf_counter()
        ranks = dryrun.dryrun_multichip(*group)
        seconds = time.perf_counter() - t1
        for results in ranks:
            check(len(results) == DRYRUN_CASES and all(
                r["same"] and r["step"] == 2 and math.isfinite(r["loss"])
                for r in results), f"dry run ({label}): a case failed")
            for r in results:
                add_launches(counts, r["launches"])
        graphs = sum(r["graph"] for r in ranks[0])
        print(f"[multi-device] (b) dry run ({label}): {len(ranks[0])} cases "
              f"ok in {seconds:.1f} s with the spawn "
              f"({seconds / len(ranks[0]):.2f} s a case); graph windows "
              f"{graphs}/{len(ranks[0])}", flush=True)
        check(graphs == (DRYRUN_CASES if group[0] == 1 else 0),
              f"dry run ({label}): {graphs} graph windows")

    # (c) bench_scaling 25 4 at the JAX default (the library path), then
    # with K1-K5 over the visible cards and as two ranks that share cuda:0.
    t1 = time.perf_counter()
    plain = bench_scaling.main(["25", "4"])
    rows = bench_scaling.main(["25", "4", "--kernels"])
    shared = bench_scaling.main(["25", "4", "--share_card", "2",
                                 "--kernels"])
    for row in plain:
        check(row["same_state"] and not any(row["launches"].values()),
              f"bench_scaling at the JAX default: {row}")
    for row in rows + shared:
        want = dla_launches(25 * 5, 5, row["devices"])
        check(row["same_state"] and row["launches"] == want,
              f"bench_scaling: {row}, launches expected {want}")
    for row in plain + rows + shared:
        check(row["windows"] == ("eager" if row["shared_card"] else "graph"),
              f"bench_scaling: windows {row['windows']}")
        add_launches(counts, row["launches"])
    print(f"[multi-device] (c) bench_scaling in "
          f"{time.perf_counter() - t1:.1f} s on {card_line()}: "
          + "; ".join(f"{way} {r['devices']} rank(s)"
                      f"{' sharing cuda:0' if r['shared_card'] else ''} "
                      f"{r['queries_per_sec']:.1f} queries/s, efficiency "
                      f"{r['scaling_efficiency']:.4f} ({r['windows']})"
                      for way, group in (("library path", plain),
                                         ("K1-K5", rows + shared))
                      for r in group), flush=True)

    # (d) The demo at the full default size with K1-K5: two stripes on
    # cuda:0, then the whole table on one rank; then at the JAX default
    # (the library path) on a fifth of the table.
    for args in (["--share_card", "2", "--kernels"],
                 ["--ranks", "1", "--kernels"],
                 ["--ranks", "1", "--rows", "2000000", "--steps", "5"]):
        t1 = time.perf_counter()
        res = shard_data_demo.main(args)
        ranks = res["ranks"]
        want = (dla_launches(res["steps"], res["steps"], ranks)
                if "--kernels" in args else dict.fromkeys(counters(), 0))
        print(f"[multi-device] (d) shard_data_demo {' '.join(args)} in "
              f"{time.perf_counter() - t1:.1f} s on {card_line()}: "
              f"{res['gb_per_device_sharded']:.4f} GB a rank of "
              f"{res['gb_replicated']:.4f}, max_memory_allocated "
              f"{res['max_memory_allocated_gb']} GB, loss "
              f"{res['loss_first']:.5f} -> {res['loss_last']:.5f}, "
              f"{res['queries_per_s']:.1f} queries/s ({res['windows']}), "
              f"stripes built in {res['build_s']} s; launches "
              f"{res['launches']}", flush=True)
        check(math.isfinite(res["loss_first"])
              and math.isfinite(res["loss_last"]), "demo: non-finite loss")
        check(res["launches"] == want, f"demo: launches {res['launches']}, "
              f"expected {want}")
        check(res["windows"] == ("eager" if ranks > 1 else "graph"),
              f"demo: windows {res['windows']}")
        check(abs(res["gb_per_device_sharded"] * ranks
                  - res["gb_replicated"]) < 1e-6, "demo: a stripe is not "
              "its share of the table")
        add_launches(counts, res["launches"])

    # (e) K1-K4 at the demo's shapes, then with the cutoff at L.
    timing = {}
    for cutoff, key in ((DEMO_CUTOFF, "demo"), (DEMO_LIST, "demo_off_path")):
        demo_step(dev, cutoff)
        for k, row in demo_timing(dev, gen, cutoff).items():
            timing.setdefault(k, {})[key] = row
    print(f"[multi-device] phase 24 in {time.perf_counter() - t0:.1f} s; "
          f"launches {counts}", flush=True)
    return counts, timing


# -- phase 25: the JAX system's benchmark scripts ----------------------------
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]   # bench.py's line
YAHOO_FEATURES, YAHOO_LIST = 700, 30   # bench_exp.py's Yahoo-like shape


def bench_window_against_eager(dev):
    """(e) The bench protocol (``make_bench_setup``, kernels off, ``--prng
    rbg``) trained 50 then 800 steps as graph windows and as eager windows
    from the same seed: state, optimizer, aux, data key and the window
    metrics bit for bit, no kernel launched. Returns the bytes of each
    graph window's pool and each eager window's peak device memory (above
    what it started with), by window length."""
    from ultra_pytorch_tpu_torch.tools.bench_common import (
        graph_pools, make_bench_setup, new_pool_bytes)

    runs, pools, peaks = {}, {}, {}
    for fuse in (True, False):
        exp = make_bench_setup(dev, prng="rbg")
        reset_counts()
        metrics = []
        for steps in (WINDOW, 800):
            before = graph_pools(dev)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics.append(exp.train_steps(steps, fuse))
            seconds = time.perf_counter() - t0
            if fuse:
                pools[steps] = new_pool_bytes(before, dev)
                what = (f"with the warm-up and capture, graph pool "
                        f"{pools[steps]} B")
            else:
                peaks[steps] = torch.cuda.max_memory_allocated() - base
                what = f"peak memory {peaks[steps]} B above its start"
            print(f"[bench] (e) {'graph' if fuse else 'eager'} window of "
                  f"{steps} steps: {seconds:.1f} s {what}; loss "
                  f"{metrics[-1]['loss']:.6f}", flush=True)
        check(read_counts() == dict.fromkeys(counters(), 0),
              f"(e) the bench protocol launched {read_counts()}")
        check(exp.eager_reason() is None, "(e) no graphs on the card")
        runs[fuse] = (exp, metrics)
    check(same_runs(runs[True], runs[False]), "(e) the 800-step graph window "
          "differs from the same window run eager")
    print(f"[bench] (e) {WINDOW} + 800 steps: graph = eager bit for bit "
          f"(state, optimizer, aux, data key, metrics)", flush=True)
    return pools, peaks


def bench_exp_step(dev):
    """(d) One DLA step on the bench protocol at bench_exp's Yahoo-like
    shape (F = 700, L = 30, cutoff 30) on a fixed batch: K1/K2
    (``use_pallas=true``) against the plain path, from the same
    initialisation; the loss within LOSS_TOL relative, both towers'
    gradients within GRAD_TOL of their largest."""
    from ultra_pytorch_tpu_torch.run.experiment import create_algorithm
    from ultra_pytorch_tpu_torch.tools.bench_common import exp_settings

    batch = demo_batch(dev, YAHOO_FEATURES, YAHOO_LIST)
    out, launches = {}, None
    for kernels in (True, False):
        settings = exp_settings(YAHOO_LIST)
        if kernels:
            settings["ranking_model_hparams"] += ",use_pallas=true"
        alg = create_algorithm(settings, YAHOO_FEATURES, 2.0, dev)
        state = alg.init_state(torch.Generator().manual_seed(1))
        before = read_counts()
        losses = alg.losses(state, batch)
        grads = torch.autograd.grad(losses[0], alg.trainable(state))
        torch.cuda.synchronize()
        if kernels:
            launches = {k: n - before[k] for k, n in read_counts().items()}
        n = len(state.params.jax_leaves())
        out[kernels] = (losses[0].item(),
                        torch.cat([g.reshape(-1) for g in grads[:n]]),
                        torch.cat([g.reshape(-1) for g in grads[n:]]))
    (loss_k, rank_k, prop_k), (loss_p, rank_p, prop_p) = out[True], out[False]
    rank_err, rank_rel = max_rel_err(rank_k, rank_p)
    prop_err, prop_rel = max_rel_err(prop_k, prop_p)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"[bench] (d) DLA step at F {YAHOO_FEATURES}, L {YAHOO_LIST} (K1/K2 "
          f"over {BATCH * YAHOO_LIST} x {YAHOO_FEATURES} rows), kernels on vs "
          f"plain: loss {loss_k:.6f} vs {loss_p:.6f} (rel {rel:.2e}, limit "
          f"{LOSS_TOL}); ranker gradient max abs {rank_err:.3e} "
          f"({rank_rel:.3e} of its largest), propensity gradient "
          f"{prop_err:.3e} ({prop_rel:.3e}) (limit {GRAD_TOL}); launches "
          f"{launches}", flush=True)
    check(math.isfinite(loss_k) and rel <= LOSS_TOL,
          "(d) the DLA loss at F 700 differs between K1/K2 and plain")
    check(rank_rel <= GRAD_TOL and prop_rel <= GRAD_TOL,
          "(d) the DLA gradients at F 700 differ between K1/K2 and plain")
    check(launches == {"K1": 1, "K2": 1, "K3": 0, "K4": 0, "K5": 0},
          f"(d) the DLA step at F 700 launched {launches}")


def phase_bench(dev, gen):
    """Phase 25: the JAX system's benchmark scripts over the port. Returns
    their runs' launches and K1/K2's timing at bench_exp's Yahoo-like
    shape."""
    from ultra_pytorch_tpu_torch.tools import bench_kernels

    t0 = time.perf_counter()
    counts = dict.fromkeys(counters(), 0)
    zero = dict.fromkeys(counters(), 0)
    pools, peaks = bench_window_against_eager(dev)

    # The five runs in one child process with their default device (the
    # card), each as its main(argv): (a) bench at its defaults, JAX's
    # protocol with the kernels off; (b) bench --kernels, K1-K5 as
    # bench_pallas.py's all_on; (c) bench_kernels; (d) bench_exp at the
    # Yahoo-like shape, without and with K1/K2.
    shape = ["--features", str(YAHOO_FEATURES), "--list-size",
             str(YAHOO_LIST)]
    runs = run_mains("bench", [
        ("ultra_pytorch_tpu_torch.bench", []),
        ("ultra_pytorch_tpu_torch.bench", ["--kernels", "--baseline-steps",
                                           "5"]),
        ("ultra_pytorch_tpu_torch.tools.bench_kernels", []),
        ("ultra_pytorch_tpu_torch.tools.bench_exp", shape),
        ("ultra_pytorch_tpu_torch.tools.bench_exp",
         shape + ["--ranker-extra", ",use_pallas=true"])], timeout=600)
    (details, last), kernels_on, ladder, *exps = [
        (json.loads(lines[-2]), json.loads(lines[-1])) for lines in runs]

    print(f"[bench] (a) {last['value']} queries/s, vs_baseline "
          f"{last['vs_baseline']} (CPU {details['baseline_queries_per_s']:.1f}"
          f" queries/s) on {card_line()}; warm-up and capture of the "
          f"{details['chunk']}-step window {details['warmup_s']:.1f} s, its "
          f"graph pool {details['pool_bytes']} B; in this process the graph "
          f"pools of {WINDOW} and 800 steps {pools[WINDOW]} and "
          f"{pools[800]} B "
          f"({pools[800] / pools[WINDOW]:.2f}x), the eager windows' peaks "
          f"{peaks[WINDOW]} and {peaks[800]} B", flush=True)
    check(list(last) == BENCH_KEYS
          and last["metric"] == "dla_dnn_train_throughput"
          and last["unit"] == "queries/s", f"(a) bench printed {last}")
    check(math.isfinite(last["value"]) and last["value"] > 0
          and math.isfinite(last["vs_baseline"]) and last["vs_baseline"] > 0,
          f"(a) bench printed {last}")
    check(details["launches"] == zero and math.isfinite(details["loss"])
          and details["steps"] == 3200 and details["chunk"] == 800,
          f"(a) bench: {details}")
    # A capture that could not reuse a step's freed blocks would grow its
    # pool by a step's working set each step; the window's plan grows with
    # the window eagerly too, so the pool is held to the eager window.
    for pool in (details["pool_bytes"], pools[800]):
        check(0 < pool < 2 * peaks[800], f"(a) an 800-step window's graph "
              f"pool of {pool} B is not under twice the eager window's peak "
              f"{peaks[800]} B")

    details, last = kernels_on
    want = dla_launches(details["steps"], details["windows"])
    print(f"[bench] (b) --kernels {last['value']} queries/s; launches "
          f"{details['launches']}", flush=True)
    check(list(last) == BENCH_KEYS and last["value"] > 0
          and details["launches"] == want and math.isfinite(details["loss"]),
          f"(b) bench --kernels: {details}, launches expected {want}")
    add_launches(counts, details["launches"])

    details, rates = ladder
    for name, ranker, algo, feed in bench_kernels.COMBOS:
        want = bench_kernels.combo_launches(ranker, algo, feed,
                                            details["steps"],
                                            details["windows"])
        check(details["launches"][name] == want and rates[name] > 0,
              f"(c) {name}: {rates[name]} queries/s, launches "
              f"{details['launches'][name]}, expected {want}")
        add_launches(counts, details["launches"][name])
    print(f"[bench] (c) on {card_line()}: " + ", ".join(
        f"{k} {v} ({v / rates['all_off']:.3f})" for k, v in rates.items()),
        flush=True)

    for (details, last), kernels in zip(exps, (False, True)):
        k = details["steps"] if kernels else 0
        want = dict(zero, K1=k, K2=k)
        print(f"[bench] (d) bench_exp F {YAHOO_FEATURES} L {YAHOO_LIST} "
              f"ranker_extra '{last['ranker_extra']}': "
              f"{last['queries_per_s']} queries/s, launches "
              f"{details['launches']}", flush=True)
        check(last["queries_per_s"] > 0 and details["launches"] == want
              and math.isfinite(details["loss"]),
              f"(d) bench_exp: {details}, expected {want}")
        add_launches(counts, details["launches"])
    bench_exp_step(dev)
    timing = demo_timing(dev, gen, YAHOO_LIST, YAHOO_FEATURES, ("K1", "K2"))
    print(f"[bench] phase 25 in {time.perf_counter() - t0:.1f} s; launches "
          f"{counts}", flush=True)
    return counts, timing


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of every weight and input")
    parser.add_argument("--serve-replays", metavar="CONFIG",
                        help="only phase 22's timing of the DNN Scorer's "
                        "replays on the checkpoint that phase 22 wrote for "
                        "CONFIG (phase 22 runs this as a child process)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if args.serve_replays:
        return serve_replays(args.serve_replays)
    from ultra_pytorch_tpu_torch.ops.kernels import mlp

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    t_start = time.perf_counter()

    def clock(phase: str) -> None:
        print(f"[clock] {phase} starts at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    phase_device()
    phase_build()
    err = {"K1": phase_parity(mlp, gen, dev),
           "K2": phase_k2_parity(mlp, gen, dev)}
    err["K3"] = err["K4"] = phase_loss_parity(gen, dev)
    err["K5"] = phase_click_parity(dev)
    serving_launches, model_dir = phase_serving(mlp, gen, dev)
    k1_timing = phase_timing(mlp, gen, dev, model_dir)[BUCKETS[-1]]
    click_json = write_click_model(WORK)
    phase_dla_step(dev, click_json)
    clock("phase 7")
    counts, pool, data = phase_training(dev, click_json)
    data_dir = phase_cli(mlp, dev, click_json)
    timing = phase_kernel_timing(mlp, gen, dev, pool)
    timing.update(phase_loss_timing(gen, dev))
    timing["K1"] = k1_timing
    phase_one_step(dev, "offline step", OFFLINE,
                   lambda algo, kernels: offline_settings(algo, kernels,
                                                          click_json))
    clock("phase 11")
    offline_counts = phase_offline_training(dev, click_json, data)
    estimator_json = phase_propensity(dev, data, click_json, data_dir)
    phase_offline_cli(mlp, dev, click_json, data, data_dir, estimator_json)
    clock("phase 14")
    ranker_counts = phase_rankers(dev, data)
    clock("phase 16")
    online_counts, online_data = phase_online(mlp, dev, data_dir)
    clock("phase 17")
    libsvm_dir, format_counts = phase_formats(click_json)
    clock("phase 18")
    dp_counts = phase_dp(dev, click_json, data_dir, libsvm_dir)
    clock("phase 19")
    fused_counts = phase_fused(dev, click_json, data, data_dir)
    clock("phase 20")
    online_fused_counts = phase_online_fused(dev, online_data, data_dir)
    clock("phase 21")
    phase_pipeline(click_json)
    convergence_counts = phase_convergence(dev)
    clock("phase 22")
    graph_counts = phase_graphs(dev, click_json, data, online_data)
    clock("phase 23")
    tool_counts = phase_tools()
    clock("phase 24")
    multi_counts, multi_timing = phase_multi_device(dev, gen)
    for k, rows in multi_timing.items():
        timing[k].update(rows)
    clock("phase 25")
    bench_counts, bench_timing = phase_bench(dev, gen)
    for k, row in bench_timing.items():
        timing[k]["bench_exp"] = row
    counts["K1"] += serving_launches
    for part in (offline_counts, ranker_counts, online_counts, format_counts,
                 dp_counts, fused_counts, online_fused_counts,
                 convergence_counts, graph_counts, tool_counts, multi_counts,
                 bench_counts):
        for k, n in part.items():
            counts[k] += n
    sources = {
        "K1": ("fused_mlp_fwd", "mlp_fwd.cu",
               "ultra_pytorch_tpu/ops/pallas/mlp.py:91"),
        "K2": ("fused_mlp_bwd", "mlp_bwd.cu",
               "ultra_pytorch_tpu/ops/pallas/mlp.py:155"),
        "K3": ("listwise_loss_fwd", "listwise_loss.cu",
               "ultra_pytorch_tpu/ops/pallas/listwise_loss.py:47"),
        "K4": ("listwise_loss_bwd", "listwise_loss.cu",
               "ultra_pytorch_tpu/ops/pallas/listwise_loss.py:56"),
        "K5": ("pbm_clicks", "click_sim.cu",
               "ultra_pytorch_tpu/ops/pallas/click_sim.py:26"),
    }
    kernels = [{
        "name": f"{k} {name}", "route": "cuda",
        "source": f"ultra_pytorch_tpu_torch/ops/kernels/csrc/{src}",
        "replaces": replaces, "launches": counts[k],
        "max_abs_err": err[k], **timing[k]}
        for k, (name, src, replaces) in sources.items()]
    from ultra_pytorch_tpu_torch.run.window import Replayable

    print("[kernels] launches through CUDA graph replays in this run: "
          + json.dumps(dict(zip(sources, Replayable.replayed))), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
