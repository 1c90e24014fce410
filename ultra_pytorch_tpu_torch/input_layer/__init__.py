"""Input feeds. Importing this package registers every feed:
ClickSimulationFeed, DirectLabelFeed and the deterministic and stochastic
online simulation feeds."""

from ultra_pytorch_tpu_torch.input_layer.feeds import (  # noqa: F401
    BaseInputFeed,
    ClickSimulationFeed,
    DeterministicOnlineSimulationFeed,
    DirectLabelFeed,
    StochasticOnlineSimulationFeed,
)
