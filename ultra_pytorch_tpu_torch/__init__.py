"""ULTRA-TPU's PyTorch/CUDA port, for NVIDIA Hopper (H100).

A second package beside the JAX one, mirroring its layout: each module
sits under the same relative path as its JAX counterpart. It imports
``torch`` and never JAX. Every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper, with a plain PyTorch version beside it
that serves CPU tensors. Ported so far, the serving path:

- ``utils``    settings grammar (``HParams``), registry, ``.npz`` checkpoints
               shared with the JAX trainer.
- ``models``   the DNN ranker (LayerNorm -> Linear -> activation).
- ``ops``      K1, the fused MLP forward (``ops/kernels/csrc/mlp_fwd.cu``).
- ``serve``    bucketed ``Scorer``, ``MicroBatcher``, HTTP service and CLI
               (``python -m ultra_pytorch_tpu_torch.serve``).
"""
