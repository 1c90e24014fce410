"""Rankers. Importing this package registers every ported ranker."""

from ultra_pytorch_tpu_torch.models.dnn import DNN  # noqa: F401
