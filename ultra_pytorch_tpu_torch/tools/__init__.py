"""The port's measurement and documentation tools, one module each, run
as ``python -m ultra_pytorch_tpu_torch.tools.<name>``: the counterparts
of the JAX package's ``tools/`` scripts of the same names.

- ``bench_common``     the bench protocol the others share.
- ``bench_exp``        the bench at another window, PRNG or shape.
- ``bench_kernels``    the bench with each kernel hparam on in turn
                       (``bench_pallas.py``'s part 3).
- ``profile_step``     µs a step of the feed, the train step and the full
                       window, as replayed CUDA graphs and eager.
- ``roofline``         the DLA step's operations and bytes counted from
                       the ranker's widths, against timed graph windows.
- ``bench_serve``      the ``Scorer`` at three buckets, plain and K1.
- ``bench_serve_http`` concurrent clients through the HTTP service, with
                       and without the ``MicroBatcher``.
- ``bench_eval``       three ways of validating, held to one another.
- ``gen_docs``         ``docs/torch_api.md`` and
                       ``docs/torch_algorithms.md``.
- ``bench_scaling``, ``shard_data_demo``: queries/s over data-parallel
                       ranks, and a sharded Istella-sized table.

The bench script itself is ``python -m ultra_pytorch_tpu_torch.bench``.

Every tool takes ``--device`` (the card by default; without one it
raises), prints the card's name and power limit first when it runs on the
card, and prints one JSON line last. Importing a tool does nothing.
"""
