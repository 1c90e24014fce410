"""The readings that an online cell's correctness limits are set from, on
the card; the benchmark's own runs never run this (``perfbench/
calibrate.py`` is the offline cells' counterpart).

    python3 -m perfbench.calibrate_online --workload <cell> --seeds a,b,...

For each seed, in one process: the program's numbers (the run's own
set-up: three one-step windows and the first full window), the
control's (the plain reference computed with TF32 on, in the program's
place, deciding with its own scores) and the fault's (the reference with
no update), each against the plain reference in float32 shadowing its
states and deciding with its scores (in the checked steps those it
produced, in the window its scoring); and a witness, the reference in
float64 shadowing the program the same way, against which the program's
and the float32 reference's numbers are read. One JSON line a seed."""

from __future__ import annotations

import argparse
import gc
import json

import torch

from perfbench import run, spec
from perfbench.yardstick import keys, mgd, trees

FAULTS = ("unchanged",)


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def tf32_forward(forward):
    """`forward(cfg, params, x)` with TF32 on for its matmuls."""
    def scored(cfg, params, x):
        _tf32(True)
        try:
            return forward(cfg, params, x)
        finally:
            _tf32(False)
    return scored


def online(cell, seed: int, device="cuda") -> dict:
    """The program's, the control's and the fault's numbers on `seed`,
    each against the plain reference shadowing its states."""
    from perfbench.drivers import online

    cfg, forward = cell.config, cell.reference.forward
    setup = online.build(cell, seed, device)
    program = online.check_steps(setup, cell.traffic["window_steps"])
    score_program = online.program_scoring(setup.exp.algorithm.ranker)
    del setup.exp
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed}

    def judge(name, readings, scoring):
        ref = online.reference(cell, seed, setup, device,
                               shadow=readings["states"],
                               recorded=readings["scores"],
                               score_program=scoring)
        out[name] = mgd.gaps(readings, ref)
        return ref

    f32 = judge("program", program, score_program)

    def witness_scoring(params, x):
        return score_program(trees.map_tree(lambda t: t.float(), params),
                             x.float()).double()

    f64 = online.reference(cell, seed, setup, device,
                           shadow=program["states"],
                           recorded=program["scores"],
                           score_program=witness_scoring,
                           dtype=torch.float64)
    out["float64_witness"] = {
        "program": mgd.gaps(program, f64),
        "reference_float32_score_gap": max(
            float((a - b).abs().max() / b.abs().max())
            for mine, wit in zip(f32["steps"], f64["steps"])
            for a, b in zip(mine["scores"], wit["scores"]))}
    table = torch.from_numpy(setup.table).to(device)
    control = mgd.follow(
        cfg, table, setup.grades, setup.ranker, tf32_forward(forward),
        cell.reference.noise,
        keys.window_seeds(seed, mgd.CHECK_STEPS + 1),
        cell.traffic["window_steps"])
    judge("control", mgd.as_program(control),
          lambda p, x: tf32_forward(forward)(cfg, p, x))
    for fault in FAULTS:
        judge(fault, mgd.as_program(online.reference(cell, seed, setup,
                                                     device, fault=fault)),
              lambda p, x: forward(cfg, p, x))
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
        print(json.dumps(online(cell, int(seed))), flush=True)


if __name__ == "__main__":
    main()
