"""The harness: one cell, one seed, one run.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name:

- ``configs/<config>.json``: the deployment (``BENCHMARK.json`` names the
  file);
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names
  the generator and driver of that kind of operation,
  ``drivers/<kind>.py``;
- ``metrics/<metric>.py``: the reader of one per-layer quantity, a
  ``read(run)`` that returns a number or None when the run holds nothing
  for it; a metric split by the end-to-end metric it moves
  (``<metric>.<kind>``) is read by the file of its quantity.

A run builds its driver and runs its set-up (data and keys from the
seed, the program's state, every shape of the cell warmed), then calls
the driver's operation in a closed loop for the window, one client, each
call as soon as the last returned. With ``trace`` a slice of whole
operations from 30% into the window is profiled (``devtrace``). After
the window it reads the end-to-end metrics (``--trace 0``) or the
per-layer ones (``--trace 1``), frees the program's device state, and
has the driver judge the window's outputs against the plain reference.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

from . import e2e

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SLICE_AT, SLICE_SHARE, SLICE_MAX_S = 0.3, 0.3, 3.0


def load_module(path: Path, name: str):
    """The module of one file, loaded by path under ``name`` (a file's own
    name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def find(roots, folder: str, filename: str) -> Path:
    """``<root>/<folder>/<filename>`` of the first root that has it."""
    for root in roots:
        path = Path(root) / folder / filename
        if path.exists():
            return path
    raise FileNotFoundError(f"no {folder}/{filename} under {list(roots)}")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    roots: tuple = (HERE,)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path | None = None,
              roots: tuple = (HERE,)) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (the repository's, or
    ``bench_path``), with its configuration (the file it names, relative
    to the benchmark file's folder) and its traffic mix (``traffic/`` of
    the first of ``roots`` that has it) read, and the metrics it
    reports."""
    bench_path = bench_path or ROOT / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((bench_path.parent / cfg["file"]).read_text())
    traffic = json.loads(find(roots, "traffic", f"{w['traffic']}.json")
                         .read_text())
    return Cell(name, config, traffic, w["chips"],
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)],
                tuple(roots))


@dataclasses.dataclass
class Run:
    """What a per-layer reader sees of one traced run. ``records``: the
    operations that returned inside the window, each a dict with ``t0``,
    ``t1``, ``ok``, ``profiled`` and its driver's fields; ``trace``: the
    profiled slice (``devtrace.DeviceTrace``), None without one."""
    cell: str
    kind: str
    config: dict
    records: list
    trace: object = None

    @property
    def host_records(self) -> list:
        """Operations outside the profiled slice (host clocks unskewed)."""
        return [r for r in self.records if not r["profiled"]]

    @property
    def slice_records(self) -> list:
        """Operations inside the profiled slice."""
        return [r for r in self.records if r["profiled"]]


def driver_class(kind: str, roots: tuple = (HERE,)):
    return load_module(find(roots, "drivers", f"{kind}.py"),
                       f"portbench.drivers.{kind}").Driver


def reader_path(name: str, roots: tuple = (HERE,)) -> Path:
    """``metrics/<name>.py``, or, where there is no such file, the file
    named by ``name`` less its last dotted parts: one reader serves a
    quantity that is split by the cells' end-to-end metric
    (``device.idle_pct.upload`` and ``.repair`` are both read by
    ``device.idle_pct.py``)."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        try:
            return find(roots, "metrics", ".".join(parts[:n]) + ".py")
        except FileNotFoundError:
            continue
    raise FileNotFoundError(f"no reader of {name} under {list(roots)}")


def metric_reader(name: str, roots: tuple = (HERE,)):
    path = reader_path(name, roots)
    return load_module(path, "portbench.metrics."
                       + path.stem.replace(".", "_")).read


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             entries=None) -> dict:
    """One run of ``cell``: the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``compared`` and,
    traced, ``breakdown``). ``entries``: the timed entry points (the
    port's by default; a control or a test puts others in their place).
    Looks for no card: the caller does."""
    import torch

    from . import devtrace

    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    driver = driver_class(cell.traffic["kind"], cell.roots)(
        cell.config, cell.traffic, seed, device, entries)
    driver.setup()
    if trace and cuda:
        devtrace.warm_profiler()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    records = []
    prof = devtrace.Slice() if trace and cuda else None
    state = "before"
    t_start = time.perf_counter()
    t_end = t_start + seconds
    slice_at = t_start + SLICE_AT * seconds
    slice_s = min(SLICE_MAX_S, SLICE_SHARE * seconds)
    while time.perf_counter() < t_end:
        if prof is not None and state == "before" \
                and time.perf_counter() >= slice_at:
            prof.start()
            state, slice_t0 = "open", time.perf_counter()
        if state == "open":
            with torch.profiler.record_function(
                    f"portbench:{cell.traffic['kind']}"):
                rec = driver.step()
        else:
            rec = driver.step()
        rec["profiled"] = state == "open"
        records.append(rec)
        if state == "open" and time.perf_counter() >= slice_t0 + slice_s:
            prof.stop()
            state = "closed"
    if state == "open":
        prof.stop()
    done = e2e.in_window(records, t_end)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    result = {"attempted": len(done),
              "failed": sum(1 for r in done if not r["ok"])}
    metrics = {}
    if not trace:
        values = driver.end_to_end(done, seconds)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"{cell.name}: the {cell.traffic['kind']} "
                               f"driver gives no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dtrace = prof.read() if prof is not None and state != "before" else None
    if trace:
        run = Run(cell.name, cell.traffic["kind"], cell.config, done, dtrace)
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.roots)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = dtrace.busy_s if dtrace else 0.0
        dev["window_s"] = dtrace.window_s if dtrace else 0.0
        if dtrace:
            result["breakdown"] = dtrace.breakdown()
    driver.free()
    compared = driver.check(done)
    result.update(correct=all(v <= lim for v, lim in compared.values()),
                  metrics=metrics, device=dev, setup_s=setup_s,
                  compared={k: {"value": v, "limit": lim}
                            for k, (v, lim) in compared.items()})
    return result
