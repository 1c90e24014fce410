"""Data parallelism over ``torch.distributed`` (``mesh.py``)."""

from ultra_pytorch_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_mean,
    close_data_parallel,
    default_backend,
    dp_train_steps,
    group_size,
    init_data_parallel,
    same_on_every_rank,
    shard_generator,
    shard_queries_for_host,
    shard_seed,
    spawn_ranks,
)
