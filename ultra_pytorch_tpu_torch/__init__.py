"""ULTRA-TPU's PyTorch/CUDA port, for NVIDIA Hopper (H100).

A second package beside the JAX one, mirroring its layout: each module
sits under the same relative path as its JAX counterpart. It imports
``torch`` and never JAX. Every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper, with a plain PyTorch version beside it
that serves CPU tensors. Ported: serving, every training path, the data
formats and data parallelism:

- ``utils``       settings grammar (``HParams``), registry, ``.npz``
                  checkpoints shared with the JAX trainer, metric logs.
- ``data``        the ULTRA, ULTRE and libsvm loaders (with the native
                  LETOR parser, ``data/native.py``), device datasets,
                  TREC ranklists.
- ``sim``         the PBM, UBM and cascade click models, the propensity
                  estimators and the ranking samplers.
- ``models``      the DNN, Linear, SetRank, DLCM and GSF rankers, and the
                  generic weight bridge to the JAX params trees.
- ``ops``         the losses and the kernels: K1/K2 the fused MLP forward
                  and backward, K3/K4 the fused listwise softmax loss and
                  its gradient, K5 the PBM click sampler (``ops/kernels``).
- ``metrics``     the eight ranking metrics.
- ``algorithms``  DLA, the offline debiasing family (Naive, IPW,
                  Regression-EM, PairDebias, LambdaRank, PRS) and the
                  online family (PDGD, DBGD, MGD, NSGD) with the
                  torch-exact flat Adagrad.
- ``input_layer`` ``ClickSimulationFeed``, ``DirectLabelFeed`` and the
                  online simulation feeds.
- ``parallel``    data parallelism over ``torch.distributed``.
- ``run``         ``Experiment``, the training CLI
                  (``python -m ultra_pytorch_tpu_torch.run``) and the
                  multi-process launcher (``run/launch.py``).
- ``serve``       bucketed ``Scorer``, ``MicroBatcher``, HTTP service and
                  CLI (``python -m ultra_pytorch_tpu_torch.serve``).
"""
