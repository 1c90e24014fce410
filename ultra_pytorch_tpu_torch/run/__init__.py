"""Training entry points: ``Experiment`` and the CLI
(``python -m ultra_pytorch_tpu_torch.run``)."""
