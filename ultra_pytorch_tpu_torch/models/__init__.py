"""Rankers. Importing this package registers every ported ranker: DNN,
Linear, SetRank, DLCM and GSF."""

from ultra_pytorch_tpu_torch.models.dlcm import DLCM  # noqa: F401
from ultra_pytorch_tpu_torch.models.dnn import DNN  # noqa: F401
from ultra_pytorch_tpu_torch.models.gsf import GSF  # noqa: F401
from ultra_pytorch_tpu_torch.models.linear import Linear  # noqa: F401
from ultra_pytorch_tpu_torch.models.setrank import SetRank  # noqa: F401
