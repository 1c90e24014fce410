"""Serve a trained checkpoint as a local HTTP ranking service.

Usage:
  python -m ultra_pytorch_tpu_torch.serve --model_dir /path/to/model
      [--port 8000] [--host 127.0.0.1] [--setting_file settings.json]
      [--warmup_batch 64 --warmup_list 64] [--device cuda] [--no_pallas]

Takes the flags of the JAX package's ``tools/serve.py`` plus ``--device``.
The checkpoint (from the JAX trainer or the port) embeds its model schema,
so ``--setting_file`` is needed only for checkpoints without it. On CUDA
each (batch, list) bucket is one CUDA graph, captured at its first
request; ``--warmup_batch`` / ``--warmup_list`` capture every bucket up
to those sizes before the server starts, as the JAX server compiles them.
Then:

  curl -s localhost:8000/healthz
  curl -s -X POST localhost:8000/v1/rank -d \\
      '{"queries": [[[0.1, ...], [0.2, ...]]]}'
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model_dir", required=True,
                   help="model dir (or .ckpt path) holding the checkpoint")
    p.add_argument("--setting_file", default=None,
                   help="optional experiment-settings JSON override")
    p.add_argument("--feature_size", type=int, default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--warmup_batch", type=int, default=0,
                   help="score every bucket up to this batch size first "
                   "(on CUDA: capture each bucket's graph)")
    p.add_argument("--warmup_list", type=int, default=0,
                   help="score every bucket up to this list size first "
                   "(on CUDA: capture each bucket's graph)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "PyTorch version of every kernel)")
    p.add_argument("--use_pallas", action="store_true", default=None,
                   help="force the fused MLP kernel K1 (DNN only; default "
                   "auto = on for the DNN on CUDA)")
    p.add_argument("--no_pallas", action="store_true",
                   help="force the plain PyTorch scoring path")
    p.add_argument("--no_batching", action="store_true",
                   help="disable request micro-batching (serve/batching.py)")
    args = p.parse_args(argv)

    from ultra_pytorch_tpu_torch.serve import Scorer, serve

    settings = None
    if args.setting_file:
        with open(args.setting_file) as fin:
            settings = json.load(fin)
    use_pallas = False if args.no_pallas else args.use_pallas
    scorer = Scorer.from_checkpoint(args.model_dir, exp_settings=settings,
                                    feature_size=args.feature_size,
                                    use_pallas=use_pallas,
                                    device=args.device)
    serve(scorer, args.host, args.port,
          warmup_batch=args.warmup_batch, warmup_list=args.warmup_list,
          batch_requests=not args.no_batching)


if __name__ == "__main__":
    main()
