"""Kernels written by hand for Hopper, each beside its plain PyTorch
version: ``mlp`` (K1 the fused MLP forward, ``csrc/mlp_fwd.cu``; K2 its
backward, ``csrc/mlp_bwd.cu``), ``listwise_loss`` (K3/K4,
``csrc/listwise_loss.cu``) and ``click_sim`` (K5, ``csrc/click_sim.cu``)."""
