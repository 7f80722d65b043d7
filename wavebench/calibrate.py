#!/usr/bin/env python3
"""The readings that the limits of a cell's check are set from, on the
card, in one process:

    python3 wavebench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--seconds 1] [--out <file.json>]

* lower readings: the program's check numbers over each seed, each a
  short closed-loop window at the cell's own size and load, run and
  checked as the benchmark runs it (``harness.run``);
* upper readings: the control, the plain reference in the program's place
  in float32 with TF32 products (the precision below the configurations'
  IEEE float32), on the same inputs, judged by the same check.

The benchmark's own runs do not run this.  It prints one JSON object: each
seed's numbers, the largest of the program's and the smallest of the
control's per number.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_readings(spec, seed: int, device) -> dict:
    """The control's check numbers on the inputs of ``seed``."""
    import torch

    from wavebench import inputs
    from wavebench.reference import transforms as R

    cell, cfg, op = spec.cell, spec.config, spec.op
    if cfg["dtype"] != "float32" or cfg["tf32"]:
        raise ValueError("the TF32 control is the precision below IEEE float32 alone")
    x = inputs.make(cell["input"], cell["shape"], int(cfg["ndim"]),
                    inputs.generator(seed, device), device)
    with R.tf32():
        out = op.reference_call(cfg, cell, torch.float32, device)(x)
    return op.check(out, x, cfg, cell)


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from wavebench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.Spec(args.workload)
    names = spec.op.CHECKS
    program, control = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run(spec, seed, args.seconds, False, device, time.perf_counter())
        program[seed] = {n: res["checks"][n]["value"] for n in names}
        print(f"program seed {seed}: {program[seed]} calls {res['attempted']}", flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",")):
        control[seed] = control_readings(spec, seed, device)
        print(f"control seed {seed}: {control[seed]}", flush=True)
    summary = {n: {"lower": max(v[n] for v in program.values()),
                   "upper": min(v[n] for v in control.values()),
                   "limit": spec.cell["limits"][n]} for n in names}
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(device),
           "program": program, "control": control, "summary": summary}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    from wavebench import harness as _h

    os.environ.update(_h.cache_env(ROOT))
    sys.exit(main())
