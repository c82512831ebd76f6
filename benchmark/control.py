"""The readings that a cell's limits are set from: the program's, and the
control's, over several seeds in one process.

    python -m benchmark.control --workload <cell> --seeds <n,n,...>
        [--control-seeds <n,...>] [--fault <name>] [--requests 1]

For each seed: the program's models with that seed's weights, the units
that the check reads through the timed path (``--requests`` requests, or a
training cell's first two updates; no clock), then the comparison with the
reference, and for the seeds of ``--control-seeds`` the same comparison
with the control in the program's place: the reference computed one
precision below the configuration's (``reference.sampling.emulate_fp8``: fp8
e4m3 weights, layer inputs and attention operands), on the program's own
inputs at each compared stage. ``--fault`` plants a fault of
``benchmark/faults.py`` in the program for every seed. One JSON line a seed
with each number's readings, then one line with the largest reading of the
program and the smallest of the control for each number. The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run as bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="seeds separated by commas")
    ap.add_argument("--control-seeds", default="", help="seeds also read with the control")
    ap.add_argument("--fault", default=None, help="a fault of benchmark/faults.py to plant")
    ap.add_argument("--requests", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    spec = bench.load_spec(bench.ROOT)
    cell, config, traffic = bench.find_cell(spec, bench.ROOT, args.workload)
    bench.require_chips(cell["chips"])
    bench.check_program(bench.ROOT)
    from ctrlv_tpu_torch.ops import _build

    _build.load()
    if args.fault:
        from . import faults

        faults.plant(args.fault, traffic["kind"])
    print(json.dumps({"workload": args.workload, "card": bench.card_report(),
                      "torch": torch.__version__, "fault": args.fault}), flush=True)
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    if "check" in traffic:
        traffic = dict(traffic, check=dict(traffic["check"], requests=args.requests))
    prog_max, ctl_min = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        runner = bench.cell_class(traffic["kind"])(config, traffic, seed, torch.device("cuda", 0))
        runner.build()
        runner.warm_up()
        for r in range(args.requests):
            runner.unit(r)
        complete = getattr(runner, "complete", None)
        if complete is not None:
            complete()
        runner.free()
        readings = runner.check(control=seed in control_seeds)
        print(json.dumps({"seed": seed, "readings": {n: [p, c] for n, p, c, _ in readings},
                          "detail": getattr(runner, "detail", None)}), flush=True)
        for name, p, c, _ in readings:
            prog_max[name] = max(prog_max.get(name, 0.0), p)
            if c is not None:
                ctl_min[name] = min(ctl_min.get(name, float("inf")), c)
        del runner
        torch.cuda.empty_cache()
    print(json.dumps({"program_max": prog_max, "control_min": ctl_min}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
