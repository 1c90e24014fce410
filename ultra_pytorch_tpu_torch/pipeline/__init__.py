"""The offline experiment pipeline's own steps in the port: the linear
initial ranker (``pipeline/initial_ranking.py``). The numpy-only
``libsvm_tools/`` steps (clean, statistics, normalize, sample, split,
prepare) run as they are; ``example/torch_dataset_pipeline.sh`` and
``example/toy/torch_offline_exp_pipeline.sh`` chain them with this module
and the port's training CLI."""
