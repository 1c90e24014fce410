"""Kernels written by hand for Hopper, each beside its plain PyTorch
version. ``mlp``: K1, the fused MLP forward (``csrc/mlp_fwd.cu``)."""
