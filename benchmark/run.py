"""Run one benchmark cell once and print its result as the last line.

    python3 -m benchmark.run --workload hgt-ogbn-mag.train --seed 7 \\
        --seconds 30 --trace 0

Runs on the card of the machine it is started on, and exits non-zero,
printing no result, when there is none (or fewer than the cell asks for),
and when a module of JAX or of the JAX package is loaded once the window
has closed. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer ones, from a run with ``trace_steps`` more steps under
the profiler. The numbers that decide ``correct`` end the standard error
and the result line, each beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache the run may write stays in the checkout, at
# a fixed path (the program's own kernels build into pyhgt_tpu_torch/_build)
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"

# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pyhgt_tpu")
GIB = float(1 << 30)


def forbidden_modules():
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def _num(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def result_line(cell, out: dict, traced: bool, device_info: dict) -> dict:
    """The last line of standard output."""
    from benchmark import spec

    if traced:
        ctx = dict(window=out["window"], trace=out["traced"] or {},
                   config=cell.config)
        metrics = spec.read_layer_metrics(cell.per_layer, ctx)
    else:
        w = out["window"]
        values = dict(
            train_targets_per_s=sum(c["targets"] for c in w["counts"])
            / w["seconds"],
            peak_mem_gib=out["peak"] / GIB,
            setup_s=out["setup_s"])
        unknown = [m["name"] for m in cell.end_to_end
                   if m["name"] not in values]
        if unknown:
            raise ValueError(f"no end-to-end metric {unknown} in the harness")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = dict(correct=bool(out["correct"]), attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=device_info)
    if traced and out["traced"]:
        t = out["traced"]
        line["device"] = dict(device_info, busy_s=t["busy_s"],
                              window_s=t["span_s"])
        line["breakdown"] = dict(device_ops=t["device_ops"],
                                 idle_gaps=t["idle_gaps"])
    line["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                      for k, v in out["checks"].items()}
    return line


def main(argv=None, *, require_cuda: bool = True, bench_path=None,
         mutate=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import session, spec

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = spec.load_cell(args.workload, bench_path)
    if require_cuda:
        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark runs on the card only")
            return 2
        if torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} cards, found "
                f"{torch.cuda.device_count()}")
            return 2
        device = torch.device("cuda", 0)
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=cell.chips)
    else:
        device = torch.device("cpu")
        info = dict(platform="cpu", kind="cpu", count=1)

    out = session.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START, log, mutate=mutate)
    info["memory_peak_bytes"] = int(out["peak"])
    bad = forbidden_modules()
    if bad:
        log(f"loaded after the window: {', '.join(bad)}")
        return 3
    line = result_line(cell, out, bool(args.trace), info)
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
