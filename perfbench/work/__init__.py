"""Operations and bytes, one module a configuration, named after it,
counted from the configuration's widths: the same count whatever
implements the step. Each gives ``flops_per_step(cfg)``; a ranker that
has a fused kernel also ``mlp_fwd(cfg, rows)`` and ``mlp_bwd(cfg,
rows)``, (operations, bytes)."""
