"""Learning algorithms. Importing this package registers every ported
algorithm: DLA and the offline debiasing family (Naive, IPW,
Regression-EM, PairDebias, LambdaRank, PRS). The online family (DBGD, MGD,
NSGD, PDGD) is not ported yet."""

from ultra_pytorch_tpu_torch.algorithms.base import (  # noqa: F401
    BaseAlgorithm,
    TrainState,
)
from ultra_pytorch_tpu_torch.algorithms.dla import DLA  # noqa: F401
from ultra_pytorch_tpu_torch.algorithms.ipw import IPWrank  # noqa: F401
from ultra_pytorch_tpu_torch.algorithms.lambda_rank import (  # noqa: F401
    LambdaRank)
from ultra_pytorch_tpu_torch.algorithms.naive import (  # noqa: F401
    NaiveAlgorithm)
from ultra_pytorch_tpu_torch.algorithms.pairwise_debias import (  # noqa: F401
    PairDebias)
from ultra_pytorch_tpu_torch.algorithms.prs_rank import PRSrank  # noqa: F401
from ultra_pytorch_tpu_torch.algorithms.regression_em import (  # noqa: F401
    RegressionEM)
