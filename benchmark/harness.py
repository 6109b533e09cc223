"""What every cell shares: finding its files by name, the two views of its
configuration, the host-clock spans, the run's record and its result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its files are
found by name, so a cell, a configuration, a traffic mix or a per-layer
metric is added by adding files and entries:

  benchmark/configs/<config>.json   the model as it is run
  benchmark/traffic/<traffic>.json  the mix: its ``driver`` (a module of
                                    ``benchmark/drivers``) and parameters
  benchmark/limits/<workload>.json  the limit of each number ``correct``
                                    compares
  benchmark/metrics/<metric>.py     ``read(run) -> float | None``
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
CACHE = ROOT / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "youtube_vln_tpu")
TOPOLOGY_KEYS = (
    "attention_probs_dropout_prob", "hidden_act", "hidden_dropout_prob",
    "hidden_size", "initializer_range", "intermediate_size",
    "max_position_embeddings", "num_attention_heads", "num_hidden_layers",
    "type_vocab_size", "vocab_size", "v_feature_size", "v_target_size",
    "v_hidden_size", "v_num_hidden_layers", "v_num_attention_heads",
    "v_intermediate_size", "bi_hidden_size", "bi_num_attention_heads",
    "v_attention_probs_dropout_prob", "v_hidden_act", "v_hidden_dropout_prob",
    "v_biattention_id", "t_biattention_id", "fusion_method",
    "fusion_dropout_prob")


def load_spec(repo: Path = REPO) -> dict:
    with open(repo / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # benchmark/configs/<config>.json
    traffic: dict         # benchmark/traffic/<traffic>.json
    limits: dict          # benchmark/limits/<workload>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, spec: Optional[dict] = None, root: Path = ROOT) -> Cell:
    spec = spec or load_spec(root.parent)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    limits_path = root / "limits" / f"{name}.json"
    return Cell(name=name, chips=entry["chips"],
                config=_json(root / "configs" / f"{entry['config']}.json"),
                traffic=_json(root / "traffic" / f"{entry['traffic']}.json"),
                limits=_json(limits_path) if limits_path.exists() else {},
                end_to_end=e2e, per_layer=per_layer)


def model_dict(config: dict) -> dict:
    """The configuration as one flat dict: topology, heads and knobs (what
    the reference and the counts read)."""
    out = {k: config[k] for k in TOPOLOGY_KEYS}
    out.update(config["heads"])
    out.update(config["knobs"])
    out["compute_dtype"] = config["dtype"]
    return out


def port_config(config: dict):
    """The configuration as the program's ``LilyConfig``."""
    from youtube_vln_tpu_torch.config import LilyConfig
    d = model_dict(config)
    d["v_biattention_id"] = tuple(d["v_biattention_id"])
    d["t_biattention_id"] = tuple(d["t_biattention_id"])
    return LilyConfig(**d)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (metric names hold dots)."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_start() -> float:
    """The epoch second the process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def use_cache_dirs() -> Path:
    """Fixed build and kernel-cache directories inside the checkout."""
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    return CACHE / "kernels"


def forbidden_loaded() -> List[str]:
    """Top-level names of ``FORBIDDEN`` packages in ``sys.modules``."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Spans:
    """Host-clock spans of one kind (ms); inside a traced segment also a
    ``trace.span`` (``bench.<name>``) that the trace labels idle gaps
    with."""

    def __init__(self, name: str):
        self.name = name
        self.ms: List[float] = []

    def __call__(self, fn, *args):
        from benchmark import trace
        t0 = time.perf_counter()
        with trace.span(self.name):
            out = fn(*args)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


@dataclasses.dataclass
class Run:
    """What a run measured, for the end-to-end values and the per-layer
    readers."""
    cell: Cell
    model: dict                          # model_dict(cell.config)
    seed: int
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    check_s: float = 0.0                 # the reference's comparison, after the window
    units: int = 0                       # requests or steps in the window
    work: int = 0                        # real beams or trajectories
    flops: float = 0.0                   # model operations of the window
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    host_wait_ms: List[float] = dataclasses.field(default_factory=list)
    traced: object = None                # trace.Trace of the traced segment
    traced_units: int = 0
    traced_s: float = 0.0                # the traced segment, host clock
    bounds_s: Dict[str, float] = dataclasses.field(default_factory=dict)  # per unit
    expected_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    # (name, value, limit): correct when every value is at most its limit
    checks: List[tuple] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    samples: list = None                 # what was compared: host batches and more
    reference: dict = None               # the reference's readings (training)
    readings: dict = None                # the program's (training)


def compared(numbers: Dict[str, float], limits: dict) -> List[tuple]:
    """(name, value, limit) of the numbers the cell's limits file holds; a
    number it does not hold is not compared.  With no limits file at all
    (``calibrate.py``) every number is listed, without a limit."""
    return [(k, v, limits.get(k)) for k, v in numbers.items()
            if k in limits or not limits]


def check_launches(run: Run) -> None:
    """The traced segment launched each kernel as often as the cell's
    shapes say (``counts.expected_launches``), by name in the trace."""
    want = {k: n * run.traced_units for k, n in run.expected_launches.items()}
    got = {k: run.traced.launches.get(k, 0) for k in run.traced.launches}
    bad = {k: (got.get(k, 0), want.get(k, 0)) for k in set(got) | set(want)
           if got.get(k, 0) != want.get(k, 0)}
    if bad:
        raise RuntimeError(f"traced launches (found, expected) over "
                           f"{run.traced_units} units: {bad}")


def traced_segment(run: Run, device, body, units: int, tries: int = 2) -> None:
    """Profiles ``body()``, which does ``units`` steps or requests, after the
    window, and keeps the reduced trace in ``run``.  A segment whose trace
    lacks a marker or a launch is taken once more, after a line on standard
    error; a second such segment ends the run."""
    from benchmark import trace
    trace.warm_up(device)
    for attempt in range(1, tries + 1):
        segs = []
        with trace.traced(segs, device):
            body()
        run.traced_units, run.traced_s = units, segs[0].host_s
        try:
            run.traced = trace.read(segs[0])
            check_launches(run)
            return
        except RuntimeError as e:
            if attempt == tries:
                raise
            print(f"benchmark: traced segment {attempt} taken again: {e}",
                  file=sys.stderr, flush=True)


def verdict(run: Run) -> bool:
    return bool(run.checks) and all(v is not None and lim is not None and v <= lim
                                    for _, v, lim in run.checks)


def report(run: Run, device_kind: str) -> dict:
    """The result line, after the compared numbers went to stderr."""
    correct = verdict(run)
    compared = {name: {"value": value, "limit": limit}
                for name, value, limit in run.checks}
    metrics = {}
    if run.trace:
        for m in run.cell.per_layer:
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.end_to_end, setup_s=run.setup_s)
        for m in run.cell.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": run.cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace:
        device["busy_s"] = run.traced.busy_s
        device["window_s"] = run.traced.window_s
        out["breakdown"] = run.traced.breakdown()
    out["compared"] = compared
    return out
