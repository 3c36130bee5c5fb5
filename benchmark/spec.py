"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix and the readers of its per-layer
metrics. Nothing here knows a cell, a configuration or a metric by name;
a new one is a new file and a new entry."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

from benchmark import reference

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# the parameters of a traffic mix, all of them read by benchmark.session:
# loader threads and queue, how often each batch is trained, the checked
# and the traced steps (every mix is a closed training loop)
TRAFFIC_KEYS = frozenset(("n_pool", "repeat", "queue_size", "check_steps",
                          "trace_steps"))


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic mix's contents
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_path: Optional[Path] = None) -> Cell:
    """The cell named ``workload``; raises ``KeyError`` on an unknown one,
    and ``ValueError`` where its configuration's reference does not model
    it or its traffic mix has other parameters than the harness reads."""
    bench = _load_json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have: {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(ROOT / configs[w["config"]]["file"])
    reference.for_config(config)
    traffic = _load_json(HERE / "traffic" / f"{w['traffic']}.json")
    if set(traffic) != TRAFFIC_KEYS:
        raise ValueError(f"traffic {w['traffic']!r} has keys {sorted(traffic)}"
                         f", the harness reads {sorted(TRAFFIC_KEYS)}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(w["name"], int(w["chips"]), config, traffic, e2e, layer)


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_layer_metrics(metrics: List[dict], ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric its reader finds something for, with its
    unit; a reader that returns None leaves its metric out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
