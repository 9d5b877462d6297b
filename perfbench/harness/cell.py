"""One run of one cell: find its files by name, check the devices, hand the
cell to its traffic generator, read the per-layer metrics, print the result.

Everything a cell is comes from files found by the names in BENCHMARK.json:

    BENCHMARK.json            the cell's configuration name, traffic mix and chips
    configs/<config>.json     the model's widths and its source
    traffic/<mix>.json        the traffic mix's parameters; "generator" names
    traffic/<generator>.py    the code that runs it (`run(ctx)`)
    workloads/<cell>.json     the limits of the comparison that decides `correct`
    metrics/<metric>.py       one reader per per-layer metric (`read(run)`)
"""

import importlib.util
import json
import statistics
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch

from perfbench.harness import program
from perfbench.harness.trace import Profiled, Spans

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file under perfbench/ whose name may hold dots."""
    spec = importlib.util.spec_from_file_location("perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    sample: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files."""
    manifest = manifest if manifest is not None else load_json(ROOT / "BENCHMARK.json")
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cellfile = load_json(BENCH / "workloads" / f"{name}.json")
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in manifest["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=int(w["chips"]), config=load_json(ROOT / conf["file"]),
                mix=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=cellfile["limits"], sample=cellfile["sample"],
                end_to_end=e2e, per_layer=per_layer)


@dataclass
class Window:
    n: int  # units of work started in the window
    failed: int  # of those, units that raised
    seconds: float  # host clock, from the first call to the synchronize after the last
    lat: list  # host seconds of each completed unit's call
    traced_units: Optional[int] = None  # units completed inside the device-only profiled phase

    @property
    def done(self) -> int:
        """Units of work completed: the rates and tails count these alone."""
        return self.n - self.failed


@dataclass
class Ctx:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    control: bool = False
    spans: Spans = None
    prof: Profiled = None
    setup_s: Optional[float] = None
    peak_bytes: Optional[int] = None

    def __post_init__(self):
        cuda = self.device.type == "cuda"
        self.spans = Spans(self.trace, cuda)
        self.prof = Profiled(self.trace, cuda)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def end_setup(self):
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def window(self, step) -> Window:
        """step(i) for i = 0, 1, ... until `seconds` have passed, then a
        synchronize; a step that raises counts as failed, and neither its
        time nor its work counts as done."""
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.prof.start()
        self.spans.live = True
        lat, failed, i = [], 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.seconds:
            ts = time.perf_counter()
            try:
                step(i)
                lat.append(time.perf_counter() - ts)
                ok = True
            except Exception:  # a failed unit is counted, the run goes on
                failed += 1
                ok = False
                if failed == 1:
                    traceback.print_exc(file=sys.stderr)
            i += 1
            self.spans.stats = not self.prof.tick(self.seconds - (time.perf_counter() - t0), ok)
        self.sync()
        t1 = time.perf_counter()
        self.spans.live, self.spans.stats = False, True
        self.prof.stop()
        self.prof.reduce()
        return Window(n=i, failed=failed, seconds=t1 - t0, lat=lat,
                      traced_units=self.prof.units.get("device"))

    def read_peak(self):
        if self.device.type == "cuda":
            self.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))


@dataclass
class Outcome:
    """What a traffic generator hands back: the end-to-end values by metric name, the
    numbers compared (name -> value) and the work counts."""
    metrics: dict
    checks: dict
    attempted: int
    failed: int
    window: Window
    items_per_unit: int = 1  # images a unit of work (a batch, a step, a request) completes
    control: dict = field(default_factory=dict)  # the control's readings (control.py)


def judge(checks: dict, limits: dict, failed: int):
    """-> (correct, {name: {"value", "limit"}}); a number without a limit, a
    sample with nothing in it, or a unit of work that raised is not correct
    (`failed` is compared with the limit 0, last)."""
    out, ok = {}, bool(checks)
    for name, value in dict(checks, failed=failed).items():
        limit = 0 if name == "failed" else limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if limit is None or value is None or not value <= limit:
            ok = False
    return ok, out


def device_info(ctx: Ctx) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
         "count": ctx.cell.chips, "memory_peak_bytes": ctx.peak_bytes}
    if ctx.trace and ctx.prof.summary is not None:
        d["busy_s"] = ctx.prof.summary["busy_s"]
        d["window_s"] = ctx.prof.summary["window_s"]
    return d


def read_per_layer(ctx: Ctx, outcome: Outcome) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for m in ctx.cell.per_layer:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py")
        value = reader.read(ctx, outcome)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(args, t_start: float) -> int:
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Ctx(cell=cell, seed=int(args.seed), seconds=float(args.seconds), trace=bool(args.trace),
              device=torch.device("cuda", 0), t_start=t_start)
    traffic = load_module(BENCH / "traffic" / f"{cell.mix['generator']}.py")
    outcome = traffic.run(ctx)
    line = result_line(ctx, outcome)
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


def result_line(ctx: Ctx, outcome: Outcome):
    """The result's JSON object, its checks printed last on stderr; None (and
    the names on stderr) where JAX or the JAX package was loaded."""
    found = program.forbidden_modules(list(sys.modules))
    if found:
        print(f"perfbench: the process loaded {found}", file=sys.stderr)
        return None
    correct, checks = judge(outcome.checks, ctx.cell.limits, outcome.failed)
    if ctx.trace:
        metrics = read_per_layer(ctx, outcome)
    else:
        units = {m["name"]: m["unit"] for m in ctx.cell.end_to_end}
        values = dict(outcome.metrics, setup_s=ctx.setup_s)
        metrics = {n: {"value": float(values[n]), "unit": u} for n, u in units.items()
                   if values.get(n) is not None}
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device_info(ctx)}
    if ctx.trace and ctx.prof.summary is not None:
        line["breakdown"] = {"device_ops": ctx.prof.summary["device_ops"],
                             "idle_gaps": ctx.prof.summary["idle_gaps"]}
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct {correct}", file=sys.stderr, flush=True)
    return line


def percentile(values, q):
    """The q-th percentile (0-100) by linear interpolation between order statistics."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values):
    return statistics.median(values) if values else None
