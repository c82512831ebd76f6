"""Run one cell of the benchmark of ``ctrlv_tpu_torch`` and print its result.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its configuration
file (``benchmark/configs/<config>.json``) gives the model's sizes, its
traffic file (``benchmark/traffic/<traffic>.json``) the kind of cell
(``benchmark/cells/<kind>.py``) and every parameter of the requests,
and each metric is read by ``benchmark/metrics/<name>.py`` (or the file of
the name's part before its first dot), so a cell, a configuration or a
metric is added with files of its own.

A run: weights made on the card from the seed and handed to the program,
one warm-up request at the cell's shapes (set-up ends there), then a closed
loop of units (requests or micro-steps) started back to back until
``--seconds`` have passed, the last one finished. Every rate is the
window's wall time over the units completed. ``--trace 1`` puts
``torch.profiler`` and the benchmark's spans over the first units of the
window and reports the per-layer metrics instead. After the window the
program's models are freed and what its timed path produced is compared
with the plain reference (``benchmark/reference``).

Two options that the benchmark's own runs never take show that this
comparison can fail: ``--fault <name>`` plants a fault of
``benchmark/faults.py`` in the program's timed path, and ``--control 1``
judges the control (the reference one precision below, in the program's
place at each compared stage) against the same limits; either run should
come out ``correct: false``.

Standard output ends with one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and
``checks``, each number compared with its limit); the lines before it say
what ran, each unit's time, the program's kernel launches, the card's
clocks and power. Standard error ends with the checks, one a line. The run
exits non-zero, printing no result, without enough CUDA devices, when JAX or
the JAX package was loaded, or when the program cannot be imported from the
checkout.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ctrlv_tpu")
_IMPORTED_AT = time.time()


def process_start() -> float:
    """When this process was started, on the wall clock."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        boot = next(float(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED_AT


class Refused(Exception):
    """The run cannot give a result; the message says why."""


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(spec: dict, root: Path, workload: str):
    """(cell entry, configuration, traffic) of ``workload``."""
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def metrics_of(spec: dict, cell: str):
    """(end-to-end entries, per-layer entries) this cell reports."""
    def applies(m):
        return cell in m["workloads"] if "workloads" in m else None

    e2e = [m for m in spec["end_to_end"] if applies(m) is not False]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if applies(m) or (applies(m) is None and m["moves"] in names)]
    return e2e, layer


def reader(root: Path, metric: dict) -> ModuleType:
    """The module that reads ``metric`` (an entry of BENCHMARK.json):
    ``metrics/<name>.py``, else the file of the name's family, the part before
    its first dot. What the module declares has to match the entry."""
    name = metric["name"]
    folder = root / "benchmark" / "metrics"
    for stem in (name, name.split(".")[0]):
        path = folder / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                "benchmark.metrics." + stem.replace(".", "_"), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            declared = {"unit": getattr(module, "UNIT", None),
                        "source": getattr(module, "SOURCE", None)}
            if "layer" in metric:
                moves = getattr(module, "MOVES", {})
                declared.update(layer=getattr(module, "LAYER", None),
                                moves=moves.get(name.partition(".")[2] or name))
            wrong = {k: (v, metric[k]) for k, v in declared.items() if v != metric[k]}
            if wrong:
                raise Refused(f"{path.name} declares for {name!r} other than BENCHMARK.json "
                              f"(declared, listed): {wrong}")
            return module
    raise Refused(f"no reader for metric {name!r} under {folder}")


def cell_class(kind: str):
    return importlib.import_module(f"benchmark.cells.{kind}").Cell


def require_chips(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false: the cell runs on the card")
    if torch.cuda.device_count() < n:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell needs {n}")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def check_program(root: Path) -> None:
    """The program under test must be the checkout's own."""
    try:
        import ctrlv_tpu_torch
    except ImportError as e:
        raise Refused(f"the program ctrlv_tpu_torch cannot be imported: {e}") from e
    where = Path(ctrlv_tpu_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        raise Refused(f"ctrlv_tpu_torch comes from {where}, not from the checkout {root}")


def card_report(index: int = 0) -> str:
    """The card's name, power limit and draw, SM clock and temperature."""
    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
                              f"--id={index}"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or f"nvidia-smi exit {out.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {type(e).__name__}"


class Window:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cell_name, cell, traffic):
        self.cell, self.runner, self.traffic = cell_name, cell, traffic
        self.setup_s = None
        self.window_s = None
        self.unit_s = []
        self.traced_units = 0  # the first units, traced with the spans
        self.trace = None  # their trace, host and device
        self.device_trace = None  # the next units', the device's operations alone
        self._work = None

    @property
    def units(self) -> int:
        return len(self.unit_s)

    @property
    def steps(self) -> int:
        return self.traffic.get("steps", 0)

    def work(self):
        """(FLOPs, sites) of one unit, from the reference on ``meta``."""
        if self._work is None:
            self._work = self.runner.work()
        return self._work

    def traced_window(self):
        return self.trace.window() if self.trace is not None else None

    def clean(self):
        """(seconds, units) of the window without the units traced with the
        spans, whose host the profiler slows; all of it where none is left."""
        n = self.traced_units if self.units > self.traced_units else 0
        return self.window_s - sum(self.unit_s[:n]), self.units - n


def run(argv=None, *, root: Path = ROOT, device: Optional[str] = None,
        chips: Callable[[int], None] = require_chips, out=sys.stdout, err=sys.stderr) -> dict:
    """One run; returns the result line's object. ``device`` and ``chips``
    let the CPU tests drive a run without a card."""
    t_start = process_start()
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None,
                    help="plant this fault of benchmark/faults.py (a check of the check)")
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the control in the program's place (a check of the check)")
    args = ap.parse_args(argv)

    spec = load_spec(root)
    cell_entry, config, traffic = find_cell(spec, root, args.workload)
    chips(cell_entry["chips"])
    check_program(ROOT)
    build_dir = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build_dir / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build_dir / "triton"))

    import torch
    from ctrlv_tpu_torch.ops import _build, _launch

    dev = torch.device(device) if device else torch.device("cuda", torch.cuda.current_device())
    on_card = dev.type == "cuda"
    e2e, layer = metrics_of(spec, args.workload)
    readers = {m["name"]: reader(root, m) for m in e2e + layer}
    if args.fault:
        from . import faults

        faults.plant(args.fault, traffic["kind"])

    build_s = None
    if on_card:
        torch.cuda.set_device(dev)
        t = time.perf_counter()
        _build.load()
        build_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats(dev)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
                      "trace": args.trace, "card": card_report() if on_card else "cpu",
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "kernel_library_s": build_s,
                      "built": _build.build_info.get("built") if on_card else None}),
          file=out, flush=True)

    runner = cell_class(traffic["kind"])(config, traffic, args.seed, dev)
    window = Window(args.workload, runner, traffic)
    runner.build()
    runner.warm_up()
    if on_card:
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()  # no full collection of set-up's objects inside the window
    window.setup_s = time.time() - t_start

    tracer = None
    if args.trace:
        from .trace import Tracer

        tracer = Tracer(runner.span_modules, traffic.get("trace_units", 1), on_card)
    _launch.reset_launch_counts()
    failed = 0
    t0 = time.perf_counter()
    paused = 0.0  # the profilers' stops between units, which no unit waits for
    while True:
        if tracer is not None:
            tracer.before(window.units)
        start = time.perf_counter()
        with torch.profiler.record_function("bench.unit"):
            ok = runner.unit(window.units)
        end = time.perf_counter()
        window.unit_s.append(end - start)
        failed += not ok
        elapsed = end - t0 - paused
        if tracer is not None:
            paused += tracer.after(window.units)
        if elapsed >= args.seconds:
            break
    window.window_s = elapsed
    if tracer is not None:
        tracer.finish(window.units)
        window.traced_units = tracer.span_units
    gc.unfreeze()
    complete = getattr(runner, "complete", None)
    if complete is not None:
        complete()  # untimed: what the check reads and a short window did not reach
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    launches = dict(_launch.LAUNCHES)
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or of the JAX package were loaded: {found}")
    print(json.dumps({"unit_s": window.unit_s, "updates": getattr(runner, "updates", None),
                      "window_s": window.window_s,
                      "setup_s": window.setup_s, "launches": launches,
                      "peak_gib": peak / 2**30, "card_after": card_report() if on_card else "cpu"}),
          file=out, flush=True)

    runner.free()
    t = time.perf_counter()
    if tracer is not None:
        window.trace, window.device_trace = tracer.traces()
    trace_s = time.perf_counter() - t
    readings = runner.check(control=bool(args.control))
    check_s = time.perf_counter() - t - trace_s
    checks = [(name, ctl if args.control and ctl is not None else prog, limit)
              for name, prog, ctl, limit in readings]

    metrics = {}
    for m in (layer if args.trace else e2e):
        value = readers[m["name"]].read(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = failed == 0 and all(value <= limit for _, value, limit in checks)
    device_entry = {"platform": "gpu" if on_card else dev.type,
                    "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                    "count": cell_entry["chips"] if on_card else 1,
                    "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": window.units, "failed": failed,
              "metrics": metrics, "device": device_entry}
    print(json.dumps({"check_s": check_s, "trace_read_s": trace_s, "profiler_stop_s": paused,
                      "check_detail": getattr(runner, "detail", None),
                      "fault": args.fault, "control": args.control,
                      "readings": {name: {"program": prog, "control": ctl}
                                   for name, prog, ctl, _ in readings},
                      "traces": [None if t is None else t.summary()
                                 for t in (window.trace, window.device_trace)]}),
          file=out, flush=True)
    busy = window.device_trace or window.trace
    if busy is not None:
        lo, hi = busy.window()
        device_entry["busy_s"] = busy.busy_s(lo, hi)
        device_entry["window_s"] = hi - lo
        result["breakdown"] = breakdown(busy, lo, hi)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or of the JAX package were loaded: {found}")
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return result


def breakdown(trace, lo: float, hi: float) -> dict:
    """The device's time by kind of kernel and its idle time by the kind it
    waited for, the ten largest of each."""
    from .yardstick import kind_of

    by_kind = {}
    for op in trace.ops:
        if lo <= op.start < hi:
            k = kind_of(op.name)
            by_kind[k] = by_kind.get(k, 0.0) + op.dur
    top = sorted(by_kind.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": trace.idle_gaps(lo, hi)}


def main(argv=None) -> int:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    try:
        run(argv)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
