"""Learning algorithms. Importing this package registers every ported
algorithm (DLA; the other ten are not ported yet)."""

from ultra_pytorch_tpu_torch.algorithms.base import (  # noqa: F401
    BaseAlgorithm,
    TrainState,
)
from ultra_pytorch_tpu_torch.algorithms.dla import DLA  # noqa: F401
