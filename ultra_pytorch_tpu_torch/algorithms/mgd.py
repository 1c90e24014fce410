"""Multileave Gradient Descent (MGD).

The port's counterpart of the JAX package's ``algorithms/mgd.py`` (Schuth
et al., WSDM'16): DBGD with ``ranker_num = 4`` perturbed rankers
multileaved in one comparison; the update is the winner-share-weighted
sum of their noises.
"""

from __future__ import annotations

from ultra_pytorch_tpu_torch.algorithms.dbgd import DBGD
from ultra_pytorch_tpu_torch.utils.registry import register


@register("algorithm", "MGD", aliases=["ultra.learning_algorithm.MGD"])
class MGD(DBGD):

    name = "mgd"

    def default_hparams(self):
        hp = super().default_hparams()
        hp.update({"ranker_num": 4})
        return hp
