"""Rank jobs of the port's data-parallel tests (``test_torch_parallel.py``).

They run in processes started with the spawn method, which import this
module by name, so it imports torch and the port only: no JAX, no test
module.
"""

from functools import partial

import torch

from ultra_pytorch_tpu_torch.parallel import (
    all_reduce_mean, close_data_parallel, dp_train_steps, init_data_parallel,
    shard_seed)
from ultra_pytorch_tpu_torch.run.experiment import (
    Experiment, create_algorithm)
from ultra_pytorch_tpu_torch.run.window import WindowGraphs


class GivenFeed:
    """A feed whose window plan is a list of given batches, one a step."""

    def __init__(self, batches):
        self.batches = batches

    def can_plan(self):
        return True

    def train_batch_plan(self, generator, start, num_steps):
        return self.batches[:num_steps]

    def batch_from_plan(self, plan, i):
        return plan[i]


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


def given_batch_window(rank, world, settings, leaves, steps, feature_size,
                       device="cpu"):
    """This rank's given batches as one data-parallel window, run eagerly
    by ``dp_train_steps`` and by the body that ``WindowGraphs`` captures:
    for each, the window's metric means and the state leaves."""
    out = {}
    for way in ("eager", "graph body"):
        alg = create_algorithm(settings, feature_size, 1.0, device=device)
        state = alg.load_state_leaves(
            alg.init_state(torch.Generator().manual_seed(0)), leaves)
        feed = GivenFeed([{k: torch.from_numpy(v[rank]).to(device)
                           for k, v in batches.items()}
                          for batches, _ in steps])
        gen = torch.Generator(device=device).manual_seed(5)
        if way == "eager":
            state, keys, means = dp_train_steps(alg, feed, state, gen,
                                                len(steps))
        else:
            graphs = WindowGraphs(alg, feed, state, gen,
                                  sync=all_reduce_mean,
                                  shard_seed=partial(shard_seed, rank=rank))
            graphs.start.fill_(state.step)
            graphs.reseed(5)
            keys, means = graphs.window(len(steps))
        out[way] = (dict(zip(keys, means.tolist())), alg.state_leaves(state))
    return out


def graph_body_windows(rank, world, data_dir, settings, steps, windows):
    """`windows` windows of `steps` steps of an Experiment that is this
    rank of a gloo group, run eagerly (``dp_train_steps``), and of a twin
    whose windows run the body that ``WindowGraphs`` captures, its
    generators reseeded as a replay reseeds them: each run's state leaves,
    data key and window metrics."""
    runs = {}
    for way in ("eager", "graph body"):
        exp = Experiment(dict(settings), data_dir, "unused", batch_size=8,
                         seed=3, dp=world, device="cpu")
        exp.setup()
        exp.init_state()
        graphs = WindowGraphs(exp.algorithm, exp.feeds["train"], exp.state,
                              exp._generator, **exp._dp_hooks())
        metrics = []
        for _ in range(windows):
            if way == "eager":
                metrics.append(exp.train_steps(steps, fuse_window=False))
                continue
            graphs.start.fill_(exp.state.step)
            graphs.reseed(exp._window_seed())
            keys, means = graphs.window(steps)
            metrics.append(dict(zip(keys, means.tolist())))
        runs[way] = {"leaves": exp.algorithm.state_leaves(exp.state),
                     "key": exp._data_key.copy(), "metrics": metrics,
                     "step": exp.state.step}
    return runs


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


def recorded_window(data_dir, settings, steps, shard_data, dp="auto"):
    """One window of `steps` steps of an Experiment (a rank of this
    process's group unless `dp` is "off") that records its own draws:
    the state leaves and window metrics; each plan's query indices, or
    each drawn batch's features where the feed cannot plan; the DBGD
    family's noises (replica draws); and the first 8 uniforms of the
    generator each training forward of the ranker gets (its dropout's
    draws; none when it gets no generator)."""
    exp = Experiment(dict(settings), data_dir, "unused", batch_size=8,
                     seed=3, dp=dp, shard_data=shard_data, device="cpu")
    exp.setup()
    exp.init_state()
    alg, feed = exp.algorithm, exp.feeds["train"]
    rec = {"batches": [], "noises": [], "dropout": []}
    if feed.can_plan():
        plan_fn = feed.train_batch_plan

        def plan(*args):
            out = plan_fn(*args)
            rec["batches"].append(out[0].numpy().copy())
            return out

        feed.train_batch_plan = plan
    else:
        batch_fn = feed.train_batch

        def batch(*args):
            out = batch_fn(*args)
            rec["batches"].append(out["features"].numpy().copy())
            return out

        feed.train_batch = batch
    if hasattr(alg, "sample_noises"):
        noise_fn = alg.sample_noises

        def noises(*args):
            out = noise_fn(*args)
            rec["noises"].append([n.numpy().copy() for n in out])
            return out

        alg.sample_noises = noises
    ranker = exp.state.params
    forward = ranker.forward

    def probed(*args, generator=None, training=False, **kwargs):
        if training and generator is not None:
            probe = torch.Generator(device=generator.device)
            probe.set_state(generator.get_state())
            rec["dropout"].append(torch.rand(8, generator=probe).numpy())
        return forward(*args, generator=generator, training=training,
                       **kwargs)

    ranker.forward = probed
    metrics = exp.train_steps(steps)
    return dict(rec, leaves=exp.algorithm.state_leaves(exp.state),
                metrics=metrics)


def one_rank_job(rank, world, init_method, data_dir, jobs):
    """Each of `jobs` (name -> (settings, steps, shard_data)) as the one
    rank of a gloo group, then, the group closed, without a group (and
    without ``shard_data``, which needs one): ``recorded_window`` of
    each, under "group" and "none"."""
    torch.set_num_threads(1)
    init_data_parallel(world, rank, "cpu", backend="gloo",
                       init_method=init_method)
    try:
        grouped = {name: recorded_window(data_dir, *job)
                   for name, job in jobs.items()}
    finally:
        close_data_parallel()
    return {name: {"group": grouped[name],
                   "none": recorded_window(data_dir, settings, steps, False,
                                           dp="off")}
            for name, (settings, steps, _) in jobs.items()}


def rank_job(rank, world, init_method, given, data_dir, windows,
             device="cpu", given_windows=(), body_windows=None,
             recorded=None):
    """Every parity job of one gloo group: `given` maps a name to
    (settings, initial leaves, steps, feature size), `windows` a name to
    (settings, steps, shard_data); the names in `given_windows` also run
    their given batches as one window (``given_batch_window``, under
    "<name> given window"), and `body_windows` maps a name to (settings,
    steps, windows) for ``graph_body_windows``, `recorded` a name to
    (settings, steps, shard_data) for ``recorded_window``. Every rank on
    `device`."""
    torch.set_num_threads(1)
    init_data_parallel(world, rank, device, backend="gloo",
                       init_method=init_method)
    try:
        out = {name: given_batch_steps(rank, *job, device=device)
               for name, job in given.items()}
        for name in given_windows:
            out[f"{name} given window"] = given_batch_window(
                rank, world, *given[name], device=device)
        for name, job in (body_windows or {}).items():
            out[name] = graph_body_windows(rank, world, data_dir, *job)
        for name, (settings, steps, shard_data) in windows.items():
            out[name] = experiment_windows(rank, world, data_dir, settings,
                                           steps, shard_data)
        for name, job in (recorded or {}).items():
            out[name] = recorded_window(data_dir, *job)
        return out
    finally:
        close_data_parallel()

