"""Benchmark: flagship HGT training throughput on one CUDA device.

    python3 -m pyhgt_tpu_torch.bench [--preset bench] [--steps 10] [--warmup 3]

Counterpart of the repository's root ``bench.py`` on its one-chip path:
``build_flagship(preset)`` → one synthetic full batch → host sort → repeated
train steps (forward with dropout, NLL, backward, global-norm clip 0.25,
AdamW with weight decay 0.01 and the no-decay mask, eps 1e-6,
``cosine_schedule(1e-3, 1000)``). Prints one JSON line::

    {"metric": "hgt_train_edges_per_s_per_chip", "value": ..., "unit": "..."}

with edges/s = valid edges × n_layers / step time, the step time in
``unit``. Runs on ``cuda`` unless ``--device cpu`` is given; with no GPU and
no such request it raises. ``--edge_bwd``, ``--softmax_pallas``,
``--[no-]seg_pallas`` and ``--[no-]edge_bf16`` override the preset as the
root harness's flags do. Its device probe, ``--fused_opt``, ``--param_bf16``
and the ``--dp/--gp/--pp`` modes are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.ops.sorted_hgt import EDGE_BWD
from pyhgt_tpu_torch.train.optim import cosine_schedule, make_optimizer
from pyhgt_tpu_torch.train.step import TrainState, make_train_step


def make_flagship_trainer(fl):
    """``(state, step)`` for a flagship: the bench's optimizer over its
    model and ``step(batch, se, labels) -> loss``."""
    optimizer = make_optimizer(
        fl.model.named_parameters(), cosine_schedule(1e-3, 1000),
        weight_decay=0.01, clip_norm=0.25)
    return TrainState(fl.model, optimizer), make_train_step(fl.loss, optimizer)


def run(preset: str = "bench", steps: int = 10, warmup: int = 3, device=None,
        seed: int = 0, **overrides) -> dict:
    """Time ``steps`` train steps after ``warmup`` and return the JSON
    record. ``device=None`` means ``cuda`` and raises without one;
    ``overrides`` replace fields of the preset's ``FlagshipConfig``."""
    fl = build_flagship(preset, device=device, seed=seed, **overrides)
    batch, labels = synth_flagship_batch(fl, seed=0, edge_fill=1.0)
    n_edges = int(batch.edge_mask.sum())
    args = fl.to_device(batch, fl.sort(batch), labels)
    _, step = make_flagship_trainer(fl)

    def sync(loss):
        # reading the value waits for the device
        value = float(loss)
        if not math.isfinite(value):
            raise FloatingPointError(f"non-finite loss {value}")

    for _ in range(warmup):
        loss = step(*args)
    if warmup:
        sync(loss)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(*args)
    sync(loss)
    dt = (time.perf_counter() - t0) / steps

    n_layers = fl.cfg.n_layers
    kind = (torch.cuda.get_device_name(fl.device)
            if fl.device.type == "cuda" else "cpu")
    return {
        # a CPU run is a check of the path, never the chip's metric
        "metric": ("hgt_train_edges_per_s_per_chip"
                   if fl.device.type == "cuda" else "hgt_train_edges_per_s_cpu"),
        "value": round(n_edges * n_layers / dt, 1),
        "unit": f"edges/s/chip ({n_layers}-layer fwd+bwd+adamw, {n_edges} "
                f"edges/batch, step {dt * 1e3:.1f} ms, {kind})",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="bench")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--edge_bf16", action="store_true", default=None,
                    help="mixed-precision per-edge stage (bf16 values, "
                         "f32 softmax/accumulation)")
    ap.add_argument("--no-edge_bf16", dest="edge_bf16", action="store_false")
    ap.add_argument("--edge_bwd", choices=EDGE_BWD, default=None,
                    help="the edge stage's backward strategy")
    ap.add_argument("--seg_pallas", action="store_true", default=None,
                    help="the live_partials kernels for the wide [E, D] "
                         "segment sums")
    ap.add_argument("--no-seg_pallas", dest="seg_pallas",
                    action="store_false")
    ap.add_argument("--softmax_pallas", action="store_true", default=None,
                    help="segment softmax through the online-partials kernel "
                         "(runs only on the legacy target aux: "
                         "seg_rank_cap=0)")
    args = ap.parse_args(argv)
    overrides = {k: getattr(args, k) for k in
                 ("edge_bf16", "edge_bwd", "seg_pallas", "softmax_pallas")
                 if getattr(args, k) is not None}
    print(json.dumps(run(args.preset, args.steps, args.warmup, args.device,
                         **overrides)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
