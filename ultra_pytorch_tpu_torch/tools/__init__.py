"""The port's measurement and documentation tools, one module each, run
as ``python -m ultra_pytorch_tpu_torch.tools.<name>``: the counterparts
of the JAX package's ``tools/`` scripts of the same names.

- ``bench_common``     the bench protocol the others share.
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

Every tool takes ``--device`` (the card by default; without one it
raises), prints the card's name and power limit first when it runs on the
card, and prints one JSON line last. Importing a tool does nothing.
"""
