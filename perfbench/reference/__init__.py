"""Plain PyTorch rankers, one module a configuration, named after it.

Each gives ``param_shapes(cfg)``, its parameter tree as weight specs
(``yardstick/weights.py``), and ``forward(cfg, params, x, mask)``, the scores
``[B, L]`` of features ``[B, L, F]`` in the features' precision. They
import nothing of the port."""
