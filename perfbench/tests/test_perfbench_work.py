"""The work counts: the DNN's against the port's tools/roofline.py at
the protocol's shapes, SetRank's against a count by hand."""

import pytest

from perfbench import spec


def test_dnn_counts_equal_roofline():
    from ultra_pytorch_tpu_torch.models.dnn import DNN
    from ultra_pytorch_tpu_torch.tools import roofline

    cfg = spec.load_json("configs", "dnn_mslr10k")
    work = spec.load_module("work", "dnn_mslr10k")
    model = DNN("hidden_layer_sizes=[512,256,128]", 136)
    step = roofline.step_work(model, 256, 10)
    assert work.flops_per_step(cfg) == step["flops_per_step"]
    assert work.mlp_fwd(cfg, 2560) == roofline.mlp_work(model, 2560)
    assert work.mlp_bwd(cfg, 2560) == roofline.mlp_bwd_work(model, 2560)
    assert work.n_params(cfg) == sum(p.numel() for p in model.parameters())
    assert work.flops_per_step(cfg) == pytest.approx(3.2843e9, rel=1e-4)


def test_setrank_count_by_hand():
    from ultra_pytorch_tpu_torch.models.setrank import SetRank

    work = spec.load_module("work", "setrank_mslr10k")
    cfg = {"features": 2, "batch_size": 1, "selection_bias_cutoff": 2,
           "ranker_hparams": {"d_model": 4, "num_heads": 2,
                              "num_layers": 1, "diff": 3}}
    # A row: input LayerNorm 12; Linears 15 + 28 + 36 + 27 + 28 + 27 + 7
    # = 168; relus 9; attention 32 + 24; residuals and LayerNorms 56.
    # Backward a row 516.
    assert work._per_row(cfg, 2) == (301, 516)
    # Two rows 1,634; losses 84, weights 24,
    # Adagrad 10 x (115 + 3) parameters.
    assert work.flops_per_step(cfg) == 2922
    model = SetRank("d_model=4,num_heads=2,num_layers=1,diff=3", 2)
    assert work.n_params(cfg) == sum(p.numel() for p in model.parameters())
