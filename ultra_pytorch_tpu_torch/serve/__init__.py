"""Online inference: a checkpoint-loading bucketed :class:`Scorer`, a
request :class:`MicroBatcher` and a dependency-free local HTTP service.
Run it with ``python -m ultra_pytorch_tpu_torch.serve``."""

from ultra_pytorch_tpu_torch.serve.scorer import Scorer
from ultra_pytorch_tpu_torch.serve.batching import MicroBatcher
from ultra_pytorch_tpu_torch.serve.http_service import make_server, serve

__all__ = ["Scorer", "MicroBatcher", "make_server", "serve"]
