"""The harness: one run of one cell, in the contract's form.

Everything is found by name. ``BENCHMARK.json`` (at the root of the
checkout) names the cell's configuration, its metrics and which cells each
metric is read in; ``workloads/<cell>.json`` holds the cell's traffic,
engine settings and correctness limits, and names its driver,
``drivers/<driver>.py``; ``configs/<config>.json`` the model's sizes; and
each per-layer metric is read by ``metrics/<metric>.py`` (with its data, if
any, in ``metrics/<metric>.json``), or by ``metrics/<base>.py`` for a
metric ``<base>.<cells>`` that has no file of its own. Adding a cell, a mix
or a metric adds files; it edits none.

A driver's ``run(r)`` returns set-up seconds, the end-to-end readings, the
counts, the peak memory, the checks ``(name, value, limit)`` that decide
``correct`` (each value has to stay at or under its limit) and, in a traced
run, the trace's context for the readers.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import model_config

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")
# Flight-recorder slots in a traced run: more than any window's spans.
RECORDER_CAPACITY = 1 << 20


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot), whole,
    is JAX's or the JAX package's. ``ray_tpu_torch`` is not ``ray_tpu``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, kind: str, cell: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those that list it, or list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def metric_file(name: str, suffix: str) -> Optional[Path]:
    """``metrics/<name><suffix>``, or for a metric named ``<base>.<part>``
    that has none, ``metrics/<base><suffix>``: one reader serves every
    variant of a metric split by cells (``idle_share.chat``,
    ``idle_share.train``)."""
    for stem in (name, name.rsplit(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}{suffix}"
        if path.exists():
            return path
    return None


def reader(name: str):
    """The ``read`` of ``metric_file(name, ".py")``."""
    path = metric_file(name, ".py")
    if path is None:
        raise SystemExit(f"no reader for the metric {name!r} in metrics/")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_data(name: str) -> Optional[dict]:
    path = metric_file(name, ".json")
    return load_json(path) if path is not None else None


@dataclasses.dataclass
class Run:
    """What a driver is given."""
    name: str
    entry: dict
    cell: dict
    sizes: model_config.Sizes
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int
    t_start: float

    def memory_peak(self) -> int:
        """Peak bytes allocated on the fullest card this process used."""
        import torch
        if not torch.cuda.is_available():
            return 0
        return max(torch.cuda.max_memory_allocated(d)
                   for d in range(torch.cuda.device_count()))


def make_run(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             bench: Optional[dict] = None, cell: Optional[dict] = None,
             sizes: Optional[model_config.Sizes] = None) -> Run:
    """A cell's run from its files; ``cell`` and ``sizes`` replace what the
    files say (the CPU tests run a cell's code at a tiny size)."""
    bench = bench or benchmark()
    entry = workload(bench, name)
    cell = cell or load_json(HERE / "workloads" / f"{name}.json")
    if cell["traffic"] != entry["traffic"]:
        raise SystemExit(f"{name}: the cell file's traffic "
                         f"{cell['traffic']!r} is not BENCHMARK.json's "
                         f"{entry['traffic']!r}")
    return Run(name=name, entry=entry, cell=cell,
               sizes=sizes or model_config.load(entry["config"]),
               seed=int(seed), seconds=float(seconds), trace=bool(trace),
               device=device, chips=int(entry["chips"]),
               t_start=t_start if t_start is not None else time.perf_counter())


def set_environment(cell: dict, trace: bool) -> None:
    """The cell file's settings of the program (``env``), every cache
    inside the checkout at a fixed path, and a flight-recorder ring that
    holds a traced window."""
    for k, v in cell.get("env", {}).items():
        os.environ[k] = str(v)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".cache"
                                             / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if trace:
        os.environ["RAY_TPU_flight_recorder_capacity"] = str(
            RECORDER_CAPACITY)


def execute(r: Run) -> Dict[str, Any]:
    """Drive the cell and build the result line (without the module check,
    which the caller makes last)."""
    driver = importlib.import_module(f"portbench.drivers.{r.cell['driver']}")
    out = driver.run(r)
    bench = benchmark() if (ROOT / "BENCHMARK.json").exists() else None
    return result_line(r, out, bench)


def device_info(r: Run, out: dict) -> dict:
    import torch
    if r.device == "cpu" or not torch.cuda.is_available():
        kind, count = "cpu", 1
    else:
        kind, count = torch.cuda.get_device_name(0), r.chips
    return {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
            "count": count, "memory_peak_bytes": int(out["memory_peak_bytes"])}


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""
    cell: str
    sizes: model_config.Sizes
    chips: int
    kind: str
    spans: List[dict]             # the flight recorder's, over the window
    slice_spans: List[dict]       # the traced slice's
    kernels: list                 # trace.Kernel rows of the slice
    slice_s: float
    busy_s: float
    work: Dict[str, Any]          # the slice's work, as its driver counts
    data: Optional[dict] = None   # the metric's own data file

    def peak(self, key: str) -> Optional[float]:
        peaks = load_json(HERE / "peaks.json")
        for kind, row in peaks.items():
            if kind == self.kind or kind.split()[1] in self.kind:
                return float(row[key])
        return None


def result_line(r: Run, out: dict, bench: Optional[dict]) -> Dict[str, Any]:
    checks = out["checks"]
    correct = (out["failed"] == 0 and out["attempted"] > 0
               and all(v <= lim for _, v, lim in checks))
    metrics: Dict[str, dict] = {}
    line: Dict[str, Any] = {"correct": bool(correct),
                            "attempted": int(out["attempted"]),
                            "failed": int(out["failed"])}
    device = device_info(r, out)
    if bench is not None and not r.trace:
        for m in metrics_for(bench, "end_to_end", r.name):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": out["setup_s"], "unit": "s"}
            elif math.isfinite(out["end_to_end"].get(m["name"], math.nan)):
                metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                      "unit": m["unit"]}
    if r.trace:
        from .trace import idle_breakdown, top_ops, union_us
        tr = out["trace"]
        tracer = tr["tracer"]
        kernels, offset = tracer.kernels()
        busy = union_us(kernels) / 1e6
        device.update(busy_s=busy, window_s=tracer.seconds)
        ctx_args = dict(cell=r.name, sizes=r.sizes, chips=r.chips,
                        kind=device["kind"], spans=tr["spans"],
                        slice_spans=tr.get("slice_spans", []),
                        kernels=kernels, slice_s=tracer.seconds,
                        busy_s=busy, work=tr["work"])
        for m in (metrics_for(bench, "per_layer", r.name) if bench else []):
            value = reader(m["name"])(Context(**ctx_args,
                                              data=metric_data(m["name"])))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                print(f"per-layer metric {m['name']}: nothing to read",
                      file=sys.stderr)
        line["breakdown"] = {
            "device_ops": top_ops(kernels),
            "idle_gaps": idle_breakdown(
                kernels, tr.get("slice_spans", []), offset,
                **({"outside": tr["host"]} if "host" in tr else {}))}
        rec = tr.get("recorder")
        if rec and rec.get("dropped", 0) > 0:
            raise RuntimeError(f"the flight recorder dropped "
                               f"{rec['dropped']} records in a traced run")
    line["metrics"] = metrics
    line["device"] = device
    line["info"] = {k: out[k] for k in ("setup_info", "check_info",
                                        "late_s_max", "window_s")
                    if k in out}
    line["info"]["end_to_end_all"] = out["end_to_end"]
    line["info"] = _finite(line["info"])
    line["compared"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return line


def _finite(x):
    """``x`` with NaN and infinities as None, so the line stays JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    t_start = time.perf_counter()
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = benchmark()
    entry = workload(bench, a.workload)
    cell = load_json(HERE / "workloads" / f"{a.workload}.json")
    set_environment(cell, bool(a.trace))
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(entry["chips"]):
        print(f"{a.workload} needs {entry['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    r = make_run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                 t_start, bench, cell)
    line = execute(r)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in line["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
