"""Run one cell of ``BENCHMARK.json`` once and print its result line.

Everything that belongs to one configuration, one cell or one per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the model's published configuration (``hf``),
  its ``architecture`` and how it is served;
- ``architectures/<architecture>.py``: the port's configuration of that
  architecture (``config(hf) -> (cfg, text)``) and whatever else a driver
  needs that depends on the model (for ``qwen3``: its seeded weights, the
  program over them and its plain reference, ``reference/qwen3.py``);
- ``workloads/<cell>.json``: the cell's traffic parameters, the driver
  that runs its path (``drivers/<driver>.py``) and its checks' limits;
- ``metrics/<metric>.py``: a reader ``read(m)`` of one per-layer metric
  (None where it finds nothing to read).

A new cell, configuration or metric is new files and new entries; no
file that is there changes.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from benchmark.tracing import DeviceTrace, breakdown, summarize

FORBIDDEN = ("jax", "jaxlib", "flax", "handwritten_ocr_tpu")


@dataclasses.dataclass
class Env:
    """What a driver gets: the cell's files, the run's arguments, and the
    hooks that mark set-up, trace the window and free the program."""

    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    control: bool = False
    faults: tuple = ()
    architecture: object = None     # the module architectures/<name>.py
    setup_s: float | None = None
    summary: dict | None = None
    _trace: DeviceTrace | None = None

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def mark_setup(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def start_trace(self) -> None:
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.trace and self.cuda:
            self._trace = DeviceTrace()
            self._trace.start()

    def stop_trace(self, ranges, t_open: float, t_close: float) -> None:
        """Stop the device trace (if one runs) and summarise it over
        [t_open, t_close] (host clock)."""
        self.sync()
        if self._trace is not None:
            self._trace.stop()
            span = (int(t_open * 1e9), int(t_close * 1e9))
            self.summary = summarize(self._trace.events(), ranges.spans, span)
            self._trace = None

    def memory_peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) \
            if self.cuda else 0

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def cell_files(spec_path: Path, name: str):
    """(BENCHMARK.json, the directory of the benchmark's files, the cell's
    entry, its workload file, its configuration file)."""
    spec = json.loads(spec_path.read_text())
    root = spec_path.parent / spec["paths"][0]
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    cell = json.loads((root / "workloads" / f"{name}.json").read_text())
    model = json.loads((spec_path.parent / config["file"]).read_text())
    return spec, root, entry, cell, model


def metric_reader(root: Path, name: str):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reported(metrics: list[dict], spec: dict, cell: str) -> list[dict]:
    """The metrics a cell reports: those that list it, and those without
    a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])}
    return [m for m in metrics
            if cell in m.get("workloads", [cell])
            and (m.get("moves") is None or m["moves"] in e2e)]


@dataclasses.dataclass
class Measured:
    """What a per-layer reader sees."""

    run: object
    cfg: object
    text: object
    summary: dict | None

    @property
    def counters(self) -> dict:
        return self.run.counters

    @property
    def work(self):
        return self.run.work

    @property
    def ranges(self):
        return self.run.ranges

    @property
    def window_s(self) -> float:
        if self.summary is not None:
            return self.summary["window_s"]
        return self.run.window.length


def architecture(root: Path, name):
    """The module ``architectures/<name>.py`` under ``root``, loaded by
    file as the metric readers are."""
    found = sorted(p.stem for p in (root / "architectures").glob("*.py"))
    if not isinstance(name, str) or name not in found:
        raise ValueError(f"no port configuration for architecture "
                         f"{name!r}; known: {found}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_architecture_" + name,
        root / "architectures" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def passed(check: tuple) -> bool:
    value, limit, *sense = check
    return value >= limit if sense == ["min"] else value <= limit


def run_cell(spec_path: Path, name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             control: bool = False, faults: tuple = ()) -> dict:
    """One run of cell ``name``; returns the result line's object."""
    spec, root, entry, cell, model = cell_files(spec_path, name)
    model_module = architecture(root, model.get("architecture"))
    env = Env(cell=cell, config=model, seed=seed, seconds=seconds,
              trace=trace, device=device, t_start=t_start, control=control,
              faults=faults, architecture=model_module)
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    run = driver.run(env)
    cfg, text = model_module.config(model["hf"])
    metrics = {}
    if trace:
        measured = Measured(run=run, cfg=cfg, text=text, summary=env.summary)
        for metric in reported(spec["per_layer"], spec, name):
            value = metric_reader(root, metric["name"])(measured)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
    else:
        for metric in reported(spec["end_to_end"], spec, name):
            value = env.setup_s if metric["name"] == "setup_s" \
                else run.rates.get(metric["name"])
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
    device_info = {"platform": "gpu" if env.cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if env.cuda
                   else "cpu",
                   "count": entry["chips"], "memory_peak_bytes": run.memory_peak,
                   "power_limit": power_limit() if env.cuda else None}
    result = {"correct": all(passed(c) for c in run.checks.values()),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if trace and env.summary is not None:
        device_info["busy_s"] = env.summary["busy_s"]
        device_info["window_s"] = env.summary["window_s"]
        result["breakdown"] = breakdown(env.summary)
    result["checks"] = {key: {"value": c[0], "limit": c[1],
                              **({"at_least": True} if c[2:] == ("min",)
                                 else {})}
                        for key, c in run.checks.items()}
    return result


def forbidden_modules(names=None) -> list[str]:
    """The JAX modules among ``names`` (default: the loaded modules),
    by whole top-level names: the port's begins with the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names
                   if name.split(".")[0] in FORBIDDEN})


def main(argv: list[str], t_start: float) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0,
                        help="run the comparison's control (not a "
                             "measured run): the program or the reference "
                             "in the precision below the configuration's")
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    spec_path = Path(__file__).resolve().parent.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    entry = next((w for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from handwritten_ocr_tpu_torch.ops import build
    build.build_all()
    result = run_cell(spec_path, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t_start,
                      control=bool(args.control))
    found = forbidden_modules()
    if found:
        print("the run loaded " + ", ".join(found) + ", which the benchmark "
              "must not import", file=sys.stderr)
        return 4
    for key, check in result["checks"].items():
        bound = "at least" if check.get("at_least") else "limit"
        print(f"check {key}: {check['value']!r} {bound} {check['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
