"""Roofline / MFU accounting of the DLA training step on the card.

The port's counterpart of the JAX package's ``tools/roofline.py``. XLA's
cost analysis has no torch counterpart, so the step is counted by hand
from the ranker's widths (``step_work``), and timed as replayed CUDA
graph windows (``Experiment.train_steps_device``) on the JAX bench
protocol (``bench_common.make_bench_setup``: DLA, the DNN at [512, 256,
128], F = 136, B = 256, L = 10, PBM clicks, the kernel hparams off as in
the JAX tool; ``--kernels`` turns K1-K5 on, ``--ranker-extra`` appends
to the ranker's hparams, ``--prng`` is the JAX tool's).

Two counts of operations a step:

* ``flops_per_step``, the step's function as XLA counts the JAX step: the
  ranker's forward, its backward in every weight and every hidden
  activation (not in the features, which take no gradient), LayerNorm,
  ELU, DLA's two softmax losses and their gradients, and the two towers'
  clip and Adagrad. ``mfu`` is this count over the step's time against
  the 3xTF32 peak (the rate of K1/K2's float32 products on the tensor
  cores), ``mfu_vs_f32`` against the float32 CUDA-core peak, and, where
  the ranker computes in bfloat16 (``compute_dtype=bfloat16``),
  ``mfu_vs_bf16_peak`` against the bfloat16 peak (the JAX tool's
  yardstick; null otherwise).
* ``kernel_flops_per_step``, what the selected kernels execute: with
  ``use_pallas`` K1's forward, K2's forward recompute and its backward
  down to the features (``mlp_work``, ``mlp_bwd_work``), with the fused
  loss K3/K4 twice (``loss_work``); null when neither runs. ``hfu`` is
  this count against the 3xTF32 peak (null likewise).

``flops_per_step``, ``bytes_per_step`` and ``mfu`` count the step's work
from the ranker's widths, whatever implements the step, so the library
path and the kernels read against one yardstick. ``bytes_per_step``
counts the fused step's bytes (each input of the ranker's pass and of
the losses read once, each output written once), the feature gather and
the optimizers' vectors. ``allow_tf32`` says whether float32 products may
run in TF32 (the library path's cuBLAS calls read it).
``products`` breaks the products (2 x in x out a row a matrix) down by
pass.

The H100 peaks are ``bench_common``'s (``ULTRA_PEAK_TF32_TFLOPS``,
``ULTRA_PEAK_F32_TFLOPS``, ``ULTRA_PEAK_HBM_GBS`` override them).

Usage: python -m ultra_pytorch_tpu_torch.tools.roofline [--batch 256]
           [--list-size 10] [--features 136] [--chunk 50] [--steps 400]
           [--prng rbg] [--ranker-extra ,compute_dtype=bfloat16]
           [--kernels] [--no-time] [--device cuda]
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Tuple

import torch

from ultra_pytorch_tpu_torch.tools import bench_common as bc

# Operations an element of the ranker's work, as K1/K2 count them.
NORM_FWD = 6     # LayerNorm: sum, sum of squares, subtract, 2 mul, add
NORM_BWD = 10    # dscale, dbias, dnhat, two means, dh
ACT_BWD = 2      # the activation's derivative at the pre-activation
# Operations an element of a list of DLA's step outside the ranker: the
# softmax that makes each tower's weights (exp, sum, divide), the IPW
# ratio and its clip.
WEIGHTS_OPS = 6
# Operations a parameter of the optimizers: the global norm (square,
# add), the clip's scale, Adagrad's accumulator (square, add), its root,
# the epsilon, the divide, the learning rate and the update.
ADAGRAD_OPS = 10
PRNG = "rbg"   # the JAX tool's --prng default


def _widths(model) -> List[Tuple[int, int]]:
    return [(layer.linear.in_features, layer.linear.out_features)
            for layer in model.layers]


def _n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def mlp_work(model, n_rows: int):
    """(operations, bytes) of one fused forward over `n_rows` rows: per
    layer 2*in*out + out for the Linear, 6*in for the LayerNorm (sum, sum
    of squares, subtract, two multiplies, add) and `out` for the
    activation; bytes read the features and weights once and write the
    scores once."""
    use_norm = model.hparams.norm == "layer"
    widths = _widths(model)
    ops = 0
    for j, (d_in, d_out) in enumerate(widths):
        ops += 2 * d_in * d_out + d_out + (NORM_FWD * d_in if use_norm
                                           else 0)
        if j != len(widths) - 1:
            ops += d_out
    features = widths[0][0]
    return n_rows * ops, 4 * (n_rows * features + _n_params(model) + n_rows)


def mlp_bwd_work(model, n_rows: int):
    """(operations, bytes) of K2 over `n_rows` rows: the forward recompute
    (``mlp_work``) plus, per layer, the two backward products dz @ W^T and
    post^T @ dz (2*in*out each), db (out), the LayerNorm backward
    (dscale, dbias, dnhat, two means, dh: 10*in) and, on every layer but
    the first, the activation's derivative (2*in). Bytes read x, g and
    the weights once and write dx and one gradient per parameter once."""
    ops, _ = mlp_work(model, n_rows)
    for j, (d_in, d_out) in enumerate(_widths(model)):
        ops += n_rows * (4 * d_in * d_out + d_out + NORM_BWD * d_in)
        if j:
            ops += n_rows * ACT_BWD * d_in
    features = model.layers[0].linear.in_features
    return ops, 4 * (2 * n_rows * features + n_rows
                     + 2 * _n_params(model))


def loss_work(batch: int, length: int):
    """(K3 operations, K3 bytes, K4 operations, K4 bytes) at [batch,
    length]. K3 per element: wl (add, 2 multiplies), the masked score, the
    running max, exp(s~ - max) (subtract, exp) and its sum, wl * (s~ - max)
    (fused multiply-add, 2) and the denominator: ~11. K4 per element: wl
    (3), the masked score, the label share (divide), exp(s~ - log Z)
    (subtract, exp), the difference and two multiplies: ~10. K3 reads the
    four inputs and writes the loss and its residual (log Z and denom a
    list, total); K4 reads the inputs, the residual and g and writes ds."""
    elems, stats = batch * length, 8 * batch + 4
    return (11 * elems, 16 * elems + stats + 4, 10 * elems,
            20 * elems + stats + 4)


def step_work(model, batch: int, list_size: int, mlp_kernels: bool = True,
              loss_kernels: bool = True) -> Dict:
    """The DLA step's operations and bytes at `batch` x `list_size` rows
    through `model` (see the module docstring): ``flops_per_step``,
    ``kernel_flops_per_step`` (of K1/K2 with `mlp_kernels`, of K3/K4 with
    `loss_kernels`; None with neither), ``bytes_per_step`` and the
    ``products`` by pass."""
    n = batch * list_size
    widths = _widths(model)
    use_norm = model.hparams.norm == "layer"
    forward, _ = mlp_work(model, n)
    backward = 0
    products = dict.fromkeys(("forward", "weights_gradient",
                              "activations_gradient", "features_gradient"),
                             0)
    for j, (d_in, d_out) in enumerate(widths):
        mm = 2 * n * d_in * d_out
        products["forward"] += mm
        products["weights_gradient"] += mm
        backward += mm + n * d_out                       # dW, db
        if j:
            products["activations_gradient"] += mm
            backward += mm + n * (ACT_BWD * d_in
                                  + (NORM_BWD * d_in if use_norm else 0))
        else:
            products["features_gradient"] += mm          # K2 only
    k3_ops, k3_bytes, k4_ops, k4_bytes = loss_work(batch, list_size)
    losses = 2 * (k3_ops + k4_ops)                       # rank and exam
    params = _n_params(model) + list_size + 1            # both towers
    rest = WEIGHTS_OPS * 2 * n + ADAGRAD_OPS * params
    fwd_bytes = mlp_work(model, n)[1]
    bwd_ops, bwd_bytes = mlp_bwd_work(model, n)
    features = widths[0][0]
    # The gather reads a row of features a document and writes the batch;
    # the optimizers read parameter, gradient and accumulator and write
    # parameter and accumulator.
    other_bytes = 4 * (2 * n * features + 5 * params)
    kernel_flops = None
    if mlp_kernels or loss_kernels:
        kernel_flops = ((forward + bwd_ops if mlp_kernels else 0)
                        + (losses if loss_kernels else 0))
    return {
        "flops_per_step": forward + backward + losses + rest,
        "kernel_flops_per_step": kernel_flops,
        "bytes_per_step": (fwd_bytes + bwd_bytes + 2 * (k3_bytes + k4_bytes)
                           + other_bytes),
        "products": products,
    }


def analyze(device, batch: int = bc.BATCH, list_size: int = bc.LIST,
            features: int = bc.FEATURES, hidden: str = bc.HIDDEN,
            chunk: int = 50, steps: int = 400, timed: bool = True,
            prng: str = PRNG, ranker_extra: str = "",
            kernels: bool = False) -> Dict:
    """The step's counts, and with `timed` its time over `steps` steps in
    graph windows of `chunk` steps (eager off the card) after one warm-up
    window, against the card's peaks, on the protocol with the extras
    (``bench_common.extras``)."""
    exp = bc.make_bench_setup(device, batch, list_size, features,
                              prng=prng, hidden=hidden,
                              **bc.extras(kernels, ranker_extra))
    ranker = exp.algorithm.ranker
    work = step_work(
        ranker, batch, list_size, bool(ranker.hparams.get("use_pallas")),
        exp.algorithm.hparams.loss_func == "fused_softmax_loss")
    flops, bytes_ = work["flops_per_step"], work["bytes_per_step"]
    bf16 = ranker.hparams.get("compute_dtype") == "bfloat16"
    out = {
        "protocol": {"batch": batch, "list_size": list_size,
                     "features": features, "hidden": hidden, "chunk": chunk,
                     "prng": prng, "kernels": kernels,
                     "ranker_extra": ranker_extra,
                     "device": str(exp.device)},
        "flops_per_step": flops,
        "flops_per_query": flops / batch,
        "kernel_flops_per_step": work["kernel_flops_per_step"],
        "bytes_per_step": bytes_,
        "bytes_per_query": bytes_ / batch,
        "arithmetic_intensity": flops / bytes_,
        "products": work["products"],
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    if not timed:
        return out
    before = bc.launch_counts()
    exp.train_steps_device(chunk)          # warm-up (and the capture)
    bc.sync(exp.device)
    n_chunks = max(steps // chunk, 1)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        exp.train_steps_device(chunk)
    bc.sync(exp.device)
    step_s = (time.perf_counter() - t0) / (n_chunks * chunk)
    achieved = flops / step_s
    out.update({
        "launches": bc.launches_since(before),
        "queries_per_sec": batch / step_s,
        "step_time_us": step_s * 1e6,
        "achieved_tflops": achieved / 1e12,
        "achieved_hbm_gbs": bytes_ / step_s / 1e9,
        "mfu": achieved / bc.PEAK_3XTF32,
        "mfu_vs_f32": achieved / bc.PEAK_F32,
        "mfu_vs_bf16_peak": achieved / bc.PEAK_BF16 if bf16 else None,
        "hfu": (None if work["kernel_flops_per_step"] is None else
                work["kernel_flops_per_step"] / step_s / bc.PEAK_3XTF32),
        "hbm_utilization": bytes_ / step_s / bc.PEAK_BYTES,
        # The least time a step could take on each resource alone.
        "compute_floor_us_3xtf32": flops / bc.PEAK_3XTF32 * 1e6,
        "compute_floor_us_f32": flops / bc.PEAK_F32 * 1e6,
        "memory_floor_us": bytes_ / bc.PEAK_BYTES * 1e6,
        "headroom_vs_3xtf32_compute_floor_x": step_s / (flops
                                                        / bc.PEAK_3XTF32),
    })
    out["bound_by"] = ("operations" if out["compute_floor_us_3xtf32"]
                       >= out["memory_floor_us"] else "bytes")
    return out


def main(argv=None) -> Dict:
    p = bc.tool_parser(__doc__.splitlines()[0], kernels=True)
    p.add_argument("--batch", type=int, default=bc.BATCH)
    p.add_argument("--list-size", type=int, default=bc.LIST)
    p.add_argument("--features", type=int, default=bc.FEATURES)
    p.add_argument("--hidden", default=bc.HIDDEN)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--prng", default=PRNG, choices=bc.PRNGS)
    p.add_argument("--ranker-extra", default="",
                   help="appended to ranking_model_hparams, e.g. "
                        "',compute_dtype=bfloat16'")
    p.add_argument("--no-time", action="store_true",
                   help="the counts only (nothing runs)")
    args = p.parse_args(argv)
    device = bc.start(args)
    out = analyze(device, args.batch, args.list_size, args.features,
                  args.hidden, args.chunk, args.steps,
                  timed=not args.no_time, prng=args.prng,
                  ranker_extra=args.ranker_extra, kernels=args.kernels)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
