"""The readings that the correctness limits are set from, on the card;
the benchmark's own runs never run this.

    python3 -m perfbench.calibrate --workload <cell> --seeds a,b,...

For each seed, in one process: the program's numbers (the run's own
set-up: three one-step windows and the first full window), the
control's (the plain reference with TF32 on, in the program's place) and
the faults' (the reference with no update, and with half of each batch
left out), each against the plain reference in float32 shadowing its
states, with each step's loss gap and the worst leaves beside them; and
a second witness: the reference in float64 shadowing the program's
states, against which both the program's and the float32 reference's
numbers are read. One JSON line a seed."""

from __future__ import annotations

import argparse
import gc
import json

import numpy as np
import torch

from perfbench import run, spec
from perfbench.yardstick import compare

FAULTS = ("unchanged", "half_batch")


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _stats(prog: dict, ref: dict) -> dict:
    """Each step's loss gap, and the leaf that reads the worst gap of the
    first gradient and of the change."""
    def worst_leaf(p, r, keep):
        names = [n for n, k in zip(ref["leaves"], keep) if k]
        return names[int(np.argmax(compare.leaf_gaps(p, r, keep)))]

    keep = compare.moving_leaves(ref["grad_norms"])
    return {"losses": [abs(a - b) / abs(b) for a, b in
                       zip(prog["losses"], ref["losses"])],
            "grad_worst_leaf": worst_leaf(prog["grad_norms"],
                                          ref["grad_norms"],
                                          [True] * len(keep)),
            "change_worst_leaf": worst_leaf(prog["change_norms"],
                                            ref["change_norms"], keep)}


def training(cell, seed: int) -> dict:
    """The program's, the control's and the faults' numbers on `seed`,
    each against the plain reference shadowing its states."""
    from perfbench.drivers import train

    setup = train.build(cell, seed, "cuda")
    program = train.check_steps(setup, cell.traffic["window_steps"])
    del setup.exp
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seed": seed}

    def judge(name, readings):
        ref = train.reference(cell, seed, setup, "cuda",
                              shadow=readings["states"])
        readings["leaves"] = ref["leaves"]
        out[name] = compare.training_gaps(readings, ref)
        out[name + "_stats"] = _stats(readings, ref)
        out["pool"] = ref["pool"]
        return ref

    f32 = judge("program", program)
    f64 = train.reference(cell, seed, setup, "cuda", shadow=program["states"],
                          dtype=torch.float64)
    out["float64_witness"] = {
        "program": compare.training_gaps(program, f64),
        "reference_float32": compare.training_gaps(f32, f64)}
    _tf32(True)
    try:
        control = train.reference(cell, seed, setup, "cuda")
    finally:
        _tf32(False)
    judge("control", control)
    for fault in FAULTS:
        judge(fault, train.reference(cell, seed, setup, "cuda",
                                     fault=fault))
    setup.tmp.cleanup()
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    cell = spec.cell(args.workload)
    run.set_precision(cell.config)
    for seed in args.seeds.split(","):
        print(json.dumps(training(cell, int(seed))), flush=True)


if __name__ == "__main__":
    main()
