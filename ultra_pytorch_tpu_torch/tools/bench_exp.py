"""Bench variants: the DLA step at another window, PRNG or shape.

The port's counterpart of the JAX package's ``tools/bench_exp.py``, on
the same protocol as ``python -m ultra_pytorch_tpu_torch.bench``
(``bench_common.make_bench_setup`` and ``time_chunks``) with its knobs
from argv: the window (``--chunk``, one CUDA graph a window on the card),
the data key's shape (``--prng``), the batch, the feature count and the
list length, and hparams appended to the ranker's (``--ranker-extra``).
Prints the JAX tool's JSON line last, with K1-K5's launches on the line
before it.

  python -m ultra_pytorch_tpu_torch.tools.bench_exp --chunk 100 --prng rbg
  python -m ultra_pytorch_tpu_torch.tools.bench_exp --features 700 \\
      --list-size 30 --ranker-extra ,use_pallas=true     # Yahoo-like
"""

from __future__ import annotations

import json
from typing import Dict

from ultra_pytorch_tpu_torch.tools import bench_common as bc


def main(argv=None) -> Dict:
    ap = bc.tool_parser(__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--prng", default="threefry2x32", choices=bc.PRNGS)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--features", type=int, default=136)
    ap.add_argument("--list-size", type=int, default=10)
    ap.add_argument("--ranker-extra", default="",
                    help="appended to ranking_model_hparams, e.g. "
                         "',use_pallas=true' or ',compute_dtype=bfloat16'")
    args = ap.parse_args(argv)
    device = bc.start(args)
    before = bc.launch_counts()
    exp = bc.make_bench_setup(device, args.batch, args.list_size,
                              args.features, ranker_extra=args.ranker_extra,
                              prng=args.prng)
    run = bc.time_chunks(exp, args.steps, args.chunk)
    print(json.dumps({"launches": bc.launches_since(before),
                      "windows": run["windows"], "steps": run["steps"],
                      "loss": run["loss"]}), flush=True)
    out = {"chunk": args.chunk, "prng": args.prng, "batch": args.batch,
           "features": args.features, "list_size": args.list_size,
           "ranker_extra": args.ranker_extra,
           "queries_per_s": round(run["queries_per_s"], 1)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
