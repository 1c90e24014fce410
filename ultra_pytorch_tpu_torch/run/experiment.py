"""Experiment assembly and the train / validation loops.

The port's counterpart of the JAX package's ``run/experiment.py``. It
reads the same experiment-JSON schema (``train/valid/
test_input_feed`` with their hparam strings, ``ranking_model``,
``learning_algorithm``, ``metrics``/``metrics_topn``/``objective_metric``),
resolves components through the registry and runs

* a training window as a Python loop over steps, with the window's
  query, click and validity draws planned once (one batched pass, so K5
  runs once per window with ``use_pallas_click=true``), or, for a feed
  that cannot plan (the online feeds, which score with the current
  ranker), the feed's batch drawn step by step;
* validation in one pass over the split with the count-weighted merge,
  ties ordered at random from (seed, step);
* checkpoints of the full train state in the JAX package's leaf order and
  format (``STATE_FORMAT``), readable by either package.

Randomness: the ranker and the propensity tower are drawn from a CPU
``torch.Generator`` seeded with ``seed``, so they are the same on every
device. The data stream is keyed by two 32-bit words (the JAX trainer's
``uint32[2]`` data key, which the checkpoint stores in the same place):
each window seeds a generator on the device from them and draws the next
two words, so a restored run continues the same stream. The feed's plan
draws from the window's generator first, then the algorithm's own draws
(Regression-EM's uniforms) come from it step by step. With a feed that
cannot plan, each step draws from it the feed's batch first, then the
algorithm's draws (the DBGD family's noises, rankings, drafting order and
clicks).

Data parallelism: an Experiment built in a process that has joined a
process group (``parallel.init_data_parallel``, one process a device) is
one rank of a data-parallel run. Its train feed draws B / N queries a
step, the window runs through ``parallel.dp_train_steps`` (the gradient,
the algorithms' batch statistics and the window's metrics averaged over
the ranks), and the window's replica generator is the same on every rank
while each rank's own draws come from its shard generator. Each rank
holds the whole train split, or with ``shard_data`` only its stripe's
queries and feature rows (``shard_queries_for_host``); validation and
test splits stay whole and every rank validates all of them. Only rank 0
writes the checkpoint; every rank restores it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ultra_pytorch_tpu_torch.algorithms.base import train_window
from ultra_pytorch_tpu_torch.data import dataset as data_lib
from ultra_pytorch_tpu_torch.data.trec import output_ranklist
from ultra_pytorch_tpu_torch.models.base import params_from_jax, params_to_jax
from ultra_pytorch_tpu_torch.parallel import mesh
from ultra_pytorch_tpu_torch.utils import checkpoint as ckpt_lib
from ultra_pytorch_tpu_torch.utils.device import resolve_device
from ultra_pytorch_tpu_torch.utils.registry import find_class

# Checkpoint state-layout version, the JAX package's (optimizer state as
# one flat vector per tower).
STATE_FORMAT = "opt-flat-r4"
# The JAX PRNG whose key layout (uint32[2]) the checkpoints carry.
PRNG_IMPL = "threefry2x32"
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
    """The 64-bit generator seed of a two-word key."""
    return (int(key[0]) << 32) | int(key[1])


def _words(seed: int) -> np.ndarray:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 1 << 32, (2,), generator=gen).numpy().astype(
        np.uint32)


class Experiment:
    """One configured experiment over a dataset directory, on one device."""

    def __init__(self, exp_settings: Dict[str, Any], data_dir: str,
                 model_dir: str, batch_size: int = 256,
                 data_format: str = "ULTRA", seed: int = 0,
                 rank_cut: Optional[int] = None, dp=None,
                 split_prefixes: Optional[Dict[str, str]] = None,
                 shard_data: bool = False, device=None):
        """`dp` takes the JAX trainer's policy values (``dp_policy``): with
        "auto" the Experiment is a rank of whatever process group this
        process has joined; "off", 0 and 1 run on one device; a count N
        needs a group of N ranks. `shard_data` keeps only this rank's
        stripe of the train split and needs a group of more than one
        rank. `device` (this rank's) defaults to CUDA."""
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
        if shard_data and self.world_size < 2:
            raise ValueError("--shard_data requires a data-parallel group "
                             "(dp > 1)")
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
        self._data_key = _words(self.seed ^ _DATA_KEY_TAG)
        return self.state

    def _window_generator(self) -> torch.Generator:
        """A generator on the device for the next window; advances the
        data key."""
        seed = _key_seed(self._data_key)
        self._data_key = _words(seed ^ _NEXT_KEY_TAG)
        return torch.Generator(device=self.device).manual_seed(seed)

    @property
    def ckpt_path(self) -> str:
        algo_name = self.exp_settings["learning_algorithm"].rsplit(".", 1)[-1]
        return os.path.join(self.model_dir, f"{algo_name}.ckpt")

    def save(self, extra: Dict[str, Any] = None) -> None:
        """Checkpoint the full train state and the data key (rank 0 only:
        every rank holds the same state)."""
        if self.rank != 0:
            return
        meta = dict(extra or {})
        meta.setdefault("prng_impl", PRNG_IMPL)
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
        ckpt_lib.save_checkpoint(
            self.ckpt_path,
            (self.algorithm.state_leaves(self.state), self._data_key), meta)

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
        if saved_prng and saved_prng != PRNG_IMPL:
            raise ValueError(
                f"checkpoint {ckpt} was written with --prng {saved_prng}; "
                f"the port reads {PRNG_IMPL} checkpoints only")
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
    def train_steps(self, num_steps: int) -> Dict[str, float]:
        """Run `num_steps` steps, their draws planned in one pass where
        the feed can plan (``algorithms.base.train_window``); returns the
        window's mean metrics as host floats (one transfer), averaged over
        the ranks under data parallelism. The window's generator goes on
        to each step after the plan has drawn from it (Regression-EM's
        uniforms)."""
        feed = self.feeds["train"]
        generator = self._window_generator()
        if self.data_parallel:
            self.state, metrics = mesh.dp_train_steps(
                self.algorithm, feed, self.state, generator, num_steps)
            return metrics
        self.state, keys, means = train_window(
            self.algorithm, feed, self.state, generator, num_steps)
        return dict(zip(keys, means.tolist()))

    # -- eval -------------------------------------------------------------
    def _metric_keys(self):
        return sorted(
            f"{m}_{n}"
            for m in self.exp_settings.get("metrics", ["mrr", "ndcg"])
            for n in self.exp_settings.get("metrics_topn", [3, 5, 10]))

    def _eval_generator(self) -> Optional[torch.Generator]:
        """Tie-break generator for this validation pass, from (seed, step);
        None when ``eval_shuffle_ties`` is off."""
        if not self.exp_settings.get("eval_shuffle_ties", True):
            return None
        seed = ((self.seed ^ _EVAL_TAG) << 32) | (self.state.step & _MASK32)
        return torch.Generator(device=self.device).manual_seed(seed)

    def validate(self, split: str = "valid") -> Dict[str, float]:
        """Metrics over the whole split: batches of ``batch_size`` queries
        and the tail, merged weighted by their query counts."""
        data = self.device_data[split]
        keys = self._metric_keys()
        gen = self._eval_generator()
        q, total = data.num_queries, None
        for start in range(0, q, self.batch_size):
            count = min(self.batch_size, q - start)
            batch = data.gather(torch.arange(start, start + count,
                                             device=self.device))
            _, summary = self.algorithm.validation_metrics(
                self.state, batch, generator=gen)
            part = torch.stack([summary[k] for k in keys]) * (count / q)
            total = part if total is None else total + part
        return dict(zip(keys, total.tolist()))

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
