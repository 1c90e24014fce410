"""Rank jobs of the port's data-parallel tests (``test_torch_parallel.py``).

They run in processes started with the spawn method, which import this
module by name, so it imports torch and the port only: no JAX, no test
module.
"""

import torch

from ultra_pytorch_tpu_torch.parallel import (
    all_reduce_mean, close_data_parallel, init_data_parallel)
from ultra_pytorch_tpu_torch.run.experiment import (
    Experiment, create_algorithm)


def given_batch_steps(rank, settings, leaves, steps, feature_size,
                      device="cpu"):
    """The port's steps on this rank's given batches, the gradient and the
    batch statistics averaged over the ranks: (losses, state leaves)."""
    alg = create_algorithm(settings, feature_size, 1.0, device=device)
    state = alg.load_state_leaves(
        alg.init_state(torch.Generator().manual_seed(0)), leaves)
    alg.grad_sync = all_reduce_mean
    losses = []
    for batches, uniforms in steps:
        batch = {k: torch.from_numpy(v[rank]).to(device)
                 for k, v in batches.items()}
        if uniforms is None:
            state, metrics = alg.train_step(state, batch)
        else:
            state, metrics = alg.step_with_uniforms(
                state, batch, torch.from_numpy(uniforms[rank]).to(device))
        losses.append(metrics["loss"].item())
    return losses, alg.state_leaves(state)


def experiment_windows(rank, world, data_dir, settings, steps, shard_data):
    """One window of `steps` steps of an Experiment that is this rank of a
    `world`-rank group: its state leaves, window metrics, the first plan's
    query indices, and its train split's qids and feature table."""
    exp = Experiment(dict(settings), data_dir, "unused", batch_size=8,
                     seed=3, dp=world, shard_data=shard_data, device="cpu")
    exp.setup()
    exp.init_state()
    feed, plans = exp.feeds["train"], []
    if feed.can_plan():
        plan_fn = feed.train_batch_plan

        def recording(*args):
            plan = plan_fn(*args)
            plans.append(plan[0].numpy().copy())
            return plan

        feed.train_batch_plan = recording
    metrics = exp.train_steps(steps)
    train = exp.datasets["train"]
    return {"leaves": exp.algorithm.state_leaves(exp.state),
            "metrics": metrics, "plans": plans, "qids": list(train.qids),
            "features": train.features.copy(),
            "batch_size": feed.batch_size}


def rank_job(rank, world, init_method, given, data_dir, windows,
             device="cpu"):
    """Every parity job of one gloo group: `given` maps a name to
    (settings, initial leaves, steps, feature size), `windows` a name to
    (settings, steps, shard_data). Every rank on `device`."""
    torch.set_num_threads(1)
    init_data_parallel(world, rank, device, backend="gloo",
                       init_method=init_method)
    try:
        out = {name: given_batch_steps(rank, *job, device=device)
               for name, job in given.items()}
        for name, (settings, steps, shard_data) in windows.items():
            out[name] = experiment_windows(rank, world, data_dir, settings,
                                           steps, shard_data)
        return out
    finally:
        close_data_parallel()

