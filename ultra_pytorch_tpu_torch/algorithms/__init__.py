"""Learning algorithms. Importing this package registers every ported
algorithm: DLA, the offline debiasing family (Naive, IPW, Regression-EM,
PairDebias, LambdaRank, PRS) and the online family (PDGD, DBGD, MGD,
NSGD)."""

from ultra_pytorch_tpu_torch.algorithms.base import (  # noqa: F401
    BaseAlgorithm,
    TrainState,
)
from ultra_pytorch_tpu_torch.algorithms.dbgd import DBGD  # noqa: F401
from ultra_pytorch_tpu_torch.algorithms.dla import DLA  # noqa: F401
from ultra_pytorch_tpu_torch.algorithms.ipw import IPWrank  # noqa: F401
from ultra_pytorch_tpu_torch.algorithms.lambda_rank import (  # noqa: F401
    LambdaRank)
from ultra_pytorch_tpu_torch.algorithms.mgd import MGD  # noqa: F401
from ultra_pytorch_tpu_torch.algorithms.naive import (  # noqa: F401
    NaiveAlgorithm)
from ultra_pytorch_tpu_torch.algorithms.nsgd import NSGD  # noqa: F401
from ultra_pytorch_tpu_torch.algorithms.pairwise_debias import (  # noqa: F401
    PairDebias)
from ultra_pytorch_tpu_torch.algorithms.pdgd import PDGD  # noqa: F401
from ultra_pytorch_tpu_torch.algorithms.prs_rank import PRSrank  # noqa: F401
from ultra_pytorch_tpu_torch.algorithms.regression_em import (  # noqa: F401
    RegressionEM)
