"""Run one cell of ``BENCHMARK.json`` and print its result.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1``
also the device's busy seconds and the traced window's length),
``breakdown`` with ``--trace 1``, and last ``checks``: each number the
correctness check compared, with its limit. The same numbers end the
standard error. Without a CUDA card, or with fewer than the cell asks
for, or with JAX loaded once the window has closed, it prints no result
and exits with another code than 0."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from perfbench import spec  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "ultra_pytorch_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`BANNED`."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(BANNED))


def set_precision(cfg) -> None:
    """The configuration's precision: float32 with TF32 off."""
    import torch

    if "TF32 off" not in cfg["precision"]:
        raise ValueError(f"unknown precision {cfg['precision']!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t0: float) -> dict:
    """The cell's run on `device`: the driver's result."""
    set_precision(cell.config)
    driver = spec.load_module("drivers", cell.traffic["driver"])
    return driver.run(cell, seed, seconds, trace, device, t0)


def result_line(cell, out: dict, trace: bool, kind: str) -> dict:
    """The printed result of a driver's `out`."""
    if trace:
        metrics = out["per_layer"]
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace and out["trace"] is not None:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = {name: {"value": out["gaps"][name], "limit": limit}
                      for name, limit in cell.limits.items()}
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                  T0)
    found = banned_modules()
    if found:
        print(f"modules loaded that the benchmark forbids: {found}",
              file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace),
                       torch.cuda.get_device_name(0))
    print(json.dumps({"notes": out["notes"]}), file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
