"""Experiment assembly and the train / validation loops.

The port's counterpart of the JAX package's ``run/experiment.py``. It
reads the same experiment-JSON schema (``train/valid/
test_input_feed`` with their hparam strings, ``ranking_model``,
``learning_algorithm``, ``metrics``/``metrics_topn``/``objective_metric``),
resolves components through the registry and runs

* a training window with the window's query, click and validity draws
  planned once where the feed can plan (one batched pass, so K5 runs once
  per window with ``use_pallas_click=true``), then the steps; the online
  feeds, which score with the current ranker, draw a batch a step
  instead. On the card the window is one captured CUDA graph a window
  length, replayed (``run/window.py``, the counterpart of the JAX
  trainer's ``jax.jit`` of a window), for all 20 configs, a
  data-parallel rank under NCCL too. Eager, as a Python loop over steps:
  on the CPU and on a gloo group (a gloo collective runs on the host and
  cannot be captured); the run says which, once;
* validation in one pass over the split with the count-weighted merge,
  ties ordered at random from (seed, step); on the card one captured
  graph a split;
* checkpoints of the full train state in the JAX package's leaf order and
  format (``STATE_FORMAT``), readable by either package.

Randomness: the ranker and the propensity tower are drawn from a CPU
``torch.Generator`` seeded with ``seed``, so they are the same on every
device. The data stream is keyed by 32-bit words in the JAX trainer's data
key's shape (``uint32[2]`` under ``--prng threefry2x32``, ``uint32[4]``
under ``rbg`` and ``unsafe_rbg``; the checkpoint stores the key in the
same place and names the PRNG in its metadata): each window seeds the
experiment's one generator on the device from them and draws the next
words, so a restored run continues the same stream. The draws themselves
are Philox whatever the flag (JAX's streams cannot be matched). The
feed's plan draws from the window's generator first, then the algorithm's
own draws (Regression-EM's uniforms) come from it step by step. With a
feed that cannot plan, each step draws from it the feed's batch first,
then the algorithm's draws (the DBGD family's noises, rankings, drafting
order and clicks).

Data parallelism: an Experiment built in a process that has joined a
process group (``parallel.init_data_parallel``, one process a device) is
one rank of a data-parallel run. Its train feed draws B / N queries a
step, the window runs through ``parallel.dp_train_steps`` (the gradient,
the algorithms' batch statistics and the window's metrics averaged over
the ranks) or, under NCCL on the card, as the same window captured with
its all-reduces in one graph, and the window's replica generator is the
same on every rank while each rank's own draws come from its shard
generator. Each rank
holds the whole train split, or with ``shard_data`` only its stripe's
queries and feature rows (``shard_queries_for_host``); validation and
test splits stay whole and every rank validates all of them. Only rank 0
writes the checkpoint; every rank restores it.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ultra_pytorch_tpu_torch.algorithms.base import train_window
from ultra_pytorch_tpu_torch.data import dataset as data_lib
from ultra_pytorch_tpu_torch.data.trec import output_ranklist
from ultra_pytorch_tpu_torch.models.base import params_from_jax, params_to_jax
from ultra_pytorch_tpu_torch.parallel import mesh
from ultra_pytorch_tpu_torch.run.window import WindowGraphs, capture
from ultra_pytorch_tpu_torch.utils import checkpoint as ckpt_lib
from ultra_pytorch_tpu_torch.utils.device import resolve_device
from ultra_pytorch_tpu_torch.utils.registry import find_class

# Checkpoint state-layout version, the JAX package's (optimizer state as
# one flat vector per tower).
STATE_FORMAT = "opt-flat-r4"
# The JAX PRNG whose key layout the checkpoints carry by default, and the
# key's uint32 words under each ``--prng``.
PRNG_IMPL = "threefry2x32"
KEY_WORDS = {PRNG_IMPL: 2, "rbg": 4, "unsafe_rbg": 4}
_DATA_KEY_TAG = 0xDA7A   # the initial data key's seed offset
_NEXT_KEY_TAG = 0x4E58   # the next window key's seed offset
_EVAL_TAG = 0x7EB7       # the validation tie-break seed offset
_MASK32 = 0xFFFFFFFF


def create_algorithm(exp_settings: Dict[str, Any], feature_size: int,
                     max_label: float, device=None):
    """Build the ranker on `device` (default CUDA) and the algorithm."""
    ranker_cls = find_class(exp_settings["ranking_model"], kind="ranker")
    ranker = ranker_cls(exp_settings.get("ranking_model_hparams", ""),
                        feature_size).to(resolve_device(device))
    algo_cls = find_class(exp_settings["learning_algorithm"],
                          kind="algorithm")
    return algo_cls(ranker, exp_settings, max_label=max_label)


def dp_policy(dp) -> Optional[int]:
    """The JAX trainer's ``--dp`` values: "auto" (or None) -> None, "off"
    -> 0, a count -> that int."""
    if isinstance(dp, str):
        return None if dp == "auto" else 0 if dp == "off" else int(dp)
    return dp


def resolve_dp(dp, batch_size: int, device) -> int:
    """The number of data-parallel ranks for the `dp` policy on `device`'s
    type: "auto" is every visible card when there is more than one and
    `batch_size` divides by their count, else 1; "off", 0 and 1 are 1; a
    count N above the visible cards, or one that does not divide
    `batch_size`, is a ValueError. CPU ranks are processes, so on the CPU
    "auto" is 1 and any count is allowed."""
    dp = dp_policy(dp)
    if dp in (0, 1):
        return 1
    n_visible = (torch.cuda.device_count()
                 if torch.device(device).type == "cuda" else None)
    if dp is None:
        n = n_visible or 1
        return n if n > 1 and batch_size % n == 0 else 1
    if n_visible is not None and dp > n_visible:
        raise ValueError(f"--dp={dp} but only {n_visible} devices visible")
    if batch_size % dp:
        raise ValueError(f"batch_size {batch_size} not divisible by dp={dp}")
    return dp


def _key_seed(key: np.ndarray) -> int:
    """The 64-bit generator seed of a key: its words in pairs, each pair
    one 64-bit value, XORed."""
    seed = 0
    for hi, lo in zip(key[0::2], key[1::2]):
        seed ^= (int(hi) << 32) | int(lo)
    return seed


def _words(seed: int, n: int = 2) -> np.ndarray:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 1 << 32, (n,), generator=gen).numpy().astype(
        np.uint32)


class Experiment:
    """One configured experiment over a dataset directory, on one device."""

    def __init__(self, exp_settings: Dict[str, Any], data_dir: str,
                 model_dir: str, batch_size: int = 256,
                 data_format: str = "ULTRA", seed: int = 0,
                 rank_cut: Optional[int] = None, dp=None,
                 split_prefixes: Optional[Dict[str, str]] = None,
                 shard_data: bool = False, device=None,
                 prng_impl: str = PRNG_IMPL):
        """`dp` takes the JAX trainer's policy values (``dp_policy``): with
        "auto" the Experiment is a rank of whatever process group this
        process has joined; "off", 0 and 1 run on one device; a count N
        needs a group of N ranks. `shard_data` keeps only this rank's
        stripe of the train split and needs a group (with one rank the
        stripe is the whole split). `device` (this rank's) defaults to
        CUDA. `prng_impl` is the JAX trainer's ``--prng``: it sets the
        data key's shape and is recorded in (and checked against) the
        checkpoint."""
        if prng_impl not in KEY_WORDS:
            raise ValueError(f"--prng {prng_impl}: one of {list(KEY_WORDS)}")
        self.prng_impl = prng_impl
        dp = dp_policy(dp)
        ranks = mesh.group_size()
        if dp not in (None, 0, 1) and dp != ranks:
            raise ValueError(
                f"dp={dp} needs a process group of {dp} ranks "
                f"(parallel.init_data_parallel), this process has "
                f"{ranks or 'none'}")
        self.data_parallel = ranks > 0 and dp not in (0, 1)
        self.world_size = ranks if self.data_parallel else 1
        self.rank = dist.get_rank() if self.data_parallel else 0
        self.backend = dist.get_backend() if self.data_parallel else None
        if shard_data and not self.data_parallel:
            raise ValueError("--shard_data requires a data-parallel group "
                             "(dp > 1, or a process group of one)")
        self.shard_data = shard_data
        self.exp_settings = exp_settings
        self.data_dir = data_dir
        self.model_dir = model_dir
        self.batch_size = batch_size
        self.data_format = data_format
        self.seed = seed
        self.rank_cut = rank_cut
        self.split_prefixes = split_prefixes or {}
        self.device = resolve_device(device)
        # The window's and the validation tie-break's generators on the
        # device, reseeded before each use (so a captured graph can keep
        # them registered); the captured windows and validation passes,
        # each with the state it was captured on (a new state is captured
        # anew).
        self._generator = torch.Generator(device=self.device)
        self._eval_gen = torch.Generator(device=self.device)
        self._window_graphs = None
        self._valid_graphs: Dict[str, Any] = {}
        self._reported = False

    # -- data -------------------------------------------------------------
    def load_split(self, split: str) -> data_lib.RankingDataset:
        click_model_dir = (self.exp_settings.get("click_model_dir")
                           if self.data_format == "ULTRE" else None)
        prefix = self.split_prefixes.get(split, split)
        return data_lib.read_data(self.data_dir, prefix, self.rank_cut,
                                  click_model_dir)

    def setup(self, splits=("train", "valid"),
              datasets: Optional[Dict[str, data_lib.RankingDataset]] = None):
        """Read the splits (or take them from `datasets`), resolve
        ``max_candidate_num`` / ``selection_bias_cutoff``, pad, put the
        data on the device and build the algorithm and the feeds."""
        given = datasets or {}
        self.datasets = {s: given[s] if s in given else self.load_split(s)
                         for s in splits}
        # From the whole data, before a stripe, so every rank has the
        # same shapes.
        max_candidate_num = max(
            d.rank_list_size for d in self.datasets.values())
        if self.shard_data and "train" in self.datasets:
            self.datasets["train"] = mesh.shard_queries_for_host(
                self.datasets["train"], self.rank, self.world_size)
        self.exp_settings["max_candidate_num"] = max_candidate_num
        cutoff = self.exp_settings.get("selection_bias_cutoff",
                                       max_candidate_num)
        self.exp_settings["selection_bias_cutoff"] = min(
            cutoff, max_candidate_num) if cutoff > 0 else max_candidate_num
        for d in self.datasets.values():
            d.pad(max_candidate_num)

        train_like = self.datasets.get("train") or next(
            iter(self.datasets.values()))
        self.max_label = max(d.max_label for d in self.datasets.values())
        self.algorithm = create_algorithm(
            self.exp_settings, train_like.feature_size, self.max_label,
            self.device)
        self.device_data = {s: d.to_device(self.device)
                            for s, d in self.datasets.items()}
        self.feeds = {}
        for split in ("train", "valid", "test"):
            if split not in self.datasets:
                continue
            feed_cls = find_class(
                self.exp_settings[f"{split}_input_feed"], kind="feed")
            self.feeds[split] = feed_cls(
                self.algorithm, self.batch_size,
                self.exp_settings.get(f"{split}_input_hparams", ""),
                self.device_data[split],
                list_size=self.datasets[split].rank_list_size,
                world_size=self.world_size if split == "train" else 1)
        return self

    # -- state ------------------------------------------------------------
    def init_state(self):
        self.state = self.algorithm.init_state(
            torch.Generator().manual_seed(self.seed))
        self._data_key = _words(self.seed ^ _DATA_KEY_TAG,
                                KEY_WORDS[self.prng_impl])
        return self.state

    def _window_seed(self) -> int:
        """The next window's generator seed; advances the data key."""
        seed = _key_seed(self._data_key)
        self._data_key = _words(seed ^ _NEXT_KEY_TAG, len(self._data_key))
        return seed

    def _window_generator(self) -> torch.Generator:
        """The device generator seeded for the next window; advances the
        data key."""
        return self._generator.manual_seed(self._window_seed())

    def snapshot_state(self):
        """A device copy of the state's tensors, its step and the data key
        (no host read), and on the card an event recorded after the copy:
        the pipelined loop saves window k's checkpoint from it after
        window k + 1 has been dispatched, and :meth:`save` reads it back
        without waiting for window k + 1."""
        tensors = [t.detach().clone()
                   for t in self.algorithm.state_tensors(self.state)]
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return tensors, self.state.step, self._data_key.copy(), ready

    @property
    def ckpt_path(self) -> str:
        algo_name = self.exp_settings["learning_algorithm"].rsplit(".", 1)[-1]
        return os.path.join(self.model_dir, f"{algo_name}.ckpt")

    def save(self, extra: Dict[str, Any] = None,
             state_and_rng=None) -> None:
        """Checkpoint the full train state and the data key (rank 0 only:
        every rank holds the same state); `state_and_rng` (a
        :meth:`snapshot_state`) in place of the live ones."""
        if self.rank != 0:
            return
        if state_and_rng is None:
            leaves = self.algorithm.state_leaves(self.state)
            key = self._data_key
        elif state_and_rng[3] is None:
            tensors, step, key, _ = state_and_rng
            leaves = self.algorithm.state_leaves(self.state, (tensors, step))
        else:
            # Read on a stream that waits for the snapshot alone, not for
            # the work dispatched after it.
            tensors, step, key, ready = state_and_rng
            side = torch.cuda.Stream(self.device)
            side.wait_event(ready)
            with torch.cuda.stream(side):
                leaves = self.algorithm.state_leaves(self.state,
                                                     (tensors, step))
        meta = dict(extra or {})
        meta.setdefault("prng_impl", self.prng_impl)
        meta.setdefault("state_format", STATE_FORMAT)
        serializable = {}
        for k, v in self.exp_settings.items():
            try:
                json.dumps(v)
                serializable[k] = v
            except TypeError:
                pass
        meta.setdefault("serve", {
            "exp_settings": serializable,
            "feature_size": int(self.datasets[next(
                iter(self.datasets))].feature_size),
            "max_label": float(self.max_label),
        })
        ckpt_lib.save_checkpoint(self.ckpt_path, (leaves, key), meta)

    def restore(self, path: Optional[str] = None,
                params_only: bool = False) -> bool:
        """Restore the full train state (or, with `params_only`, the
        ranker's weights alone) from `path` or ``<model_dir>/<algo>.ckpt``;
        False when there is none at the default path."""
        ckpt = path or self.ckpt_path
        if ckpt.endswith(".npz"):
            ckpt = ckpt[: -len(".npz")]
        if not ckpt_lib.checkpoint_exists(ckpt):
            if path:
                raise FileNotFoundError(
                    f"--start_checkpoint {path}: no checkpoint there")
            return False
        if not hasattr(self, "state"):
            self.init_state()
        if params_only:
            params_from_jax(self.state.params, ckpt_lib.load_params_prefix(
                ckpt, params_to_jax(self.state.params)))
            return True
        meta = ckpt_lib.read_metadata(ckpt)
        saved_prng = meta.get("prng_impl")
        if saved_prng and saved_prng != self.prng_impl:
            raise ValueError(
                f"checkpoint {ckpt} was written with --prng {saved_prng} "
                f"but this run uses --prng {self.prng_impl}; rerun with "
                "the matching --prng (key shapes differ)")
        saved_fmt = meta.get("state_format", "opt-per-leaf-r3")
        if saved_fmt != STATE_FORMAT:
            raise ValueError(
                f"checkpoint {ckpt} uses state layout '{saved_fmt}' but "
                f"this build reads '{STATE_FORMAT}'. Pass "
                "--restore_params_only to carry the ranker weights into a "
                "fresh optimizer state")
        (leaves, key), _ = ckpt_lib.load_checkpoint(
            ckpt, (self.algorithm.state_leaves(self.state), self._data_key))
        self.state = self.algorithm.load_state_leaves(self.state, leaves)
        self._data_key = np.asarray(key, np.uint32)
        return True

    # -- train ------------------------------------------------------------
    def eager_reason(self) -> Optional[str]:
        """Why training windows run eager here, or None when each window
        is a replayed CUDA graph."""
        if self.device.type != "cuda":
            return "CUDA graphs exist only on the card"
        if self.data_parallel and self.backend != "nccl":
            return (f"data parallelism over {self.backend}: its "
                    "collectives run on the host and cannot be captured")
        return None

    def _report_windows(self) -> None:
        """Say once how training windows run."""
        if self._reported or self.rank != 0:
            return
        self._reported = True
        reason = self.eager_reason()
        captured = "captured CUDA graphs, one a window length" + (
            ", the all-reduces inside" if self.data_parallel else "")
        print("Training windows: " + (
            captured if reason is None else f"eager ({reason})"), flush=True)

    def train_steps_device(self, num_steps: int, fuse_window: bool = True
                           ) -> Tuple[List[str], torch.Tensor]:
        """Run `num_steps` steps, their draws planned in one pass where the
        feed can plan, else a batch a step at the device step
        (``algorithms.base.train_window``): on the card a captured CUDA
        graph for this window length, replayed, a data-parallel one under
        NCCL too (see :meth:`eager_reason`; `fuse_window=False` runs the
        window eager).
        Returns the metric names and the window means as one device tensor,
        averaged over the ranks under data parallelism, without a host
        read. The window's generator goes on to each step after the plan
        has drawn from it (Regression-EM's uniforms)."""
        self._report_windows()
        feed = self.feeds["train"]
        seed = self._window_seed()
        if fuse_window and self.eager_reason() is None:
            graphs = self._window_graphs
            if graphs is None or graphs.state is not self.state:
                graphs = self._window_graphs = WindowGraphs(
                    self.algorithm, feed, self.state, self._generator,
                    **self._dp_hooks())
            return graphs.run(seed, num_steps)
        if self.data_parallel:
            self.state, keys, means = mesh.dp_train_steps(
                self.algorithm, feed, self.state,
                self._generator.manual_seed(seed), num_steps)
            return keys, means
        self.state, keys, means = train_window(
            self.algorithm, feed, self.state,
            self._generator.manual_seed(seed), num_steps)
        return keys, means

    def _dp_hooks(self) -> Dict[str, Any]:
        """A data-parallel rank's ``WindowGraphs`` arguments: the
        cross-rank mean, and with more than one rank this rank's shard
        seed; none on one device."""
        if not self.data_parallel:
            return {}
        hooks = {"sync": mesh.all_reduce_mean}
        if self.world_size > 1:
            hooks["shard_seed"] = functools.partial(mesh.shard_seed,
                                                    rank=self.rank)
        return hooks

    def train_steps(self, num_steps: int, fuse_window: bool = True
                    ) -> Dict[str, float]:
        """:meth:`train_steps_device`, its window means read as host floats
        (one transfer)."""
        keys, means = self.train_steps_device(num_steps, fuse_window)
        return dict(zip(keys, means.tolist()))

    # -- eval -------------------------------------------------------------
    def _metric_keys(self):
        return sorted(
            f"{m}_{n}"
            for m in self.exp_settings.get("metrics", ["mrr", "ndcg"])
            for n in self.exp_settings.get("metrics_topn", [3, 5, 10]))

    def _shuffle_ties(self) -> bool:
        return bool(self.exp_settings.get("eval_shuffle_ties", True))

    def _eval_generator(self) -> Optional[torch.Generator]:
        """The tie-break generator seeded for this validation pass from
        (seed, step); None when ``eval_shuffle_ties`` is off."""
        if not self._shuffle_ties():
            return None
        seed = ((self.seed ^ _EVAL_TAG) << 32) | (self.state.step & _MASK32)
        return self._eval_gen.manual_seed(seed)

    def _validation_pass(self, split: str,
                         generator: Optional[torch.Generator]
                         ) -> torch.Tensor:
        """The split's metrics in :meth:`_metric_keys` order as one device
        tensor: batches of ``batch_size`` queries and the tail, merged
        weighted by their query counts."""
        data = self.device_data[split]
        keys = self._metric_keys()
        q, total = data.num_queries, None
        for start in range(0, q, self.batch_size):
            count = min(self.batch_size, q - start)
            batch = data.gather(torch.arange(start, start + count,
                                             device=self.device))
            _, summary = self.algorithm.validation_metrics(
                self.state, batch, generator=generator)
            part = torch.stack([summary[k] for k in keys]) * (count / q)
            total = part if total is None else total + part
        return total

    def validate_device(self, split: str = "valid"
                        ) -> Tuple[List[str], torch.Tensor]:
        """A full validation pass without a host read: the metric names and
        their values as one device tensor. On the card the pass is one
        captured CUDA graph a split, replayed with the tie-break generator
        reseeded; elsewhere it runs eager."""
        keys = self._metric_keys()
        gen = self._eval_generator()
        if self.device.type != "cuda":
            return keys, self._validation_pass(split, gen)
        held = self._valid_graphs.get(split)
        if held is None or held[0] is not self.state:
            graph, out = capture(
                lambda: self._validation_pass(
                    split, self._eval_gen if self._shuffle_ties() else None),
                [self._eval_gen], name=f"validate.{split}")
            held = self._valid_graphs[split] = (self.state, graph, out)
        _, graph, out = held
        graph.replay()
        return keys, out.clone()

    def validate(self, split: str = "valid") -> Dict[str, float]:
        """:meth:`validate_device`, read as host floats (one transfer)."""
        keys, values = self.validate_device(split)
        return dict(zip(keys, values.tolist()))

    def test_scores(self, split: str = "test") -> np.ndarray:
        """Scores over the full split in initial-list order ``[Q, L]``."""
        chunks = []
        for batch, _, count in self.feeds[split].eval_batches():
            scores = self.algorithm.score(self.state, batch)
            chunks.append(scores[:count].cpu().numpy())
        return np.concatenate(chunks, axis=0)

    def write_ranklist(self, split: str = "test", output_dir: str = None):
        scores = self.test_scores(split)
        return output_ranklist(self.datasets[split], scores,
                               output_dir or self.model_dir, split), scores
