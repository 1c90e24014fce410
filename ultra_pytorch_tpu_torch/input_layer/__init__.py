"""Input feeds. Importing this package registers every ported feed
(ClickSimulationFeed, DirectLabelFeed; the online feeds are not ported
yet)."""

from ultra_pytorch_tpu_torch.input_layer.feeds import (  # noqa: F401
    BaseInputFeed,
    ClickSimulationFeed,
    DirectLabelFeed,
)
