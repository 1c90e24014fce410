"""Kernel on/off evaluation end to end: the DLA step with each kernel
hparam switched on in turn.

The port's counterpart of part 3 of the JAX package's
``tools/bench_pallas.py`` (the port's ``ops/pallas`` is ``ops/kernels``,
hence the name): the bench protocol (``bench_common.make_bench_setup``)
in windows of 25 steps, one CUDA graph a window on the card, for the
seven combinations of that script in its order and with its extras, each
reported as queries/s against ``all_off``. ``rounds_resample`` is the
feed's ``resample_strategy=rounds`` (nine draws a slot, no auto-sized
pool); the feed still plans the window's draws in one pass, as the JAX
feed does.

Parts 1 and 2 of the JAX script live elsewhere: each kernel against its
plain version on the card is ``chip_smoke.py`` phase 3, and each
kernel's device time against its plain version and the library's is
``chip_smoke.py`` phases 5 and 9, ``torch_mlp_probe.py`` (K1/K2) and
``torch_loss_probe.py`` (K3/K4).

Prints a line a combination, one JSON line of K1-K5's launches a
combination, then the JAX script's JSON dict of queries/s last.

Usage: python -m ultra_pytorch_tpu_torch.tools.bench_kernels [--steps 200]
           [--device cuda]
"""

from __future__ import annotations

import json
from typing import Dict

from ultra_pytorch_tpu_torch.tools import bench_common as bc

CHUNK = 25
# (name, ranker extra, algorithm hparams, feed extra), as bench_pallas.py.
COMBOS = (
    ("all_off", "", "", ""),
    ("pallas_mlp", ",use_pallas=true", "", ""),
    ("fused_loss", "", "loss_func=fused_softmax_loss", ""),
    ("pallas_click", "", "", ",use_pallas_click=true"),
    ("all_on", *bc.KERNEL_EXTRAS),
    ("bf16", ",compute_dtype=bfloat16", "", ""),
    ("rounds_resample", "", "", ",resample_strategy=rounds"),
)


def combo_launches(ranker: str, algo: str, feed: str, steps: int,
                   windows: int) -> Dict[str, int]:
    """The launches a combination's extras select over `steps` steps in
    `windows` windows: K1 = K2 = steps with ``use_pallas``, K3 = K4 = 2 x
    steps with the fused loss (both towers), K5 = windows + 1 (the feed's
    click-rate estimate) with ``use_pallas_click``."""
    on = bc.dla_launches(steps, windows)
    pick = {"K1": "use_pallas=true" in ranker,
            "K3": "fused_softmax_loss" in algo,
            "K5": "use_pallas_click=true" in feed}
    pick.update(K2=pick["K1"], K4=pick["K3"])
    return {k: on[k] if pick[k] else 0 for k in bc.KERNELS}


def main(argv=None) -> Dict[str, float]:
    p = bc.tool_parser(__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    args = p.parse_args(argv)
    device = bc.start(args)
    print(f"== part 3: end-to-end DLA step (queries/s), window {CHUNK} on "
          f"{device}", flush=True)
    results, launches = {}, {}
    for name, ranker, algo, feed in COMBOS:
        print(f"  {name}:", flush=True)
        before = bc.launch_counts()
        exp = bc.make_bench_setup(device, ranker_extra=ranker,
                                  algo_extra=algo, feed_extra=feed)
        run = bc.time_chunks(exp, args.steps, CHUNK)
        launches[name] = bc.launches_since(before)
        results[name] = qps = run["queries_per_s"]
        base = results["all_off"]
        print(f"  {name:14s} {qps:12.0f} q/s  "
              f"({qps / base - 1:+.1%} vs all_off)", flush=True)
    print(json.dumps({"launches": launches, "steps": run["steps"],
                      "windows": run["windows"]}), flush=True)
    out = {k: round(v, 1) for k, v in results.items()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
