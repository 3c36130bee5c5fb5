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
``--[no-]seg_pallas``, ``--[no-]edge_bf16`` and ``--param_bf16`` override
the preset as the root harness's flags do; ``--fused_opt`` selects the
flattened-vector AdamW (``train.optim.fused_adamw``). Before it builds
anything on the card it runs the root harness's bounded device probe: a
subprocess that adds to a small CUDA tensor and synchronizes, within
``--probe_timeout`` seconds; on failure it prints the error and exits 2,
never falling back to the CPU (``--no-probe`` skips it; ``--probe_retries``
extra attempts, default 0 since the card is local,
``--probe_retry_sleep`` seconds apart).

``--dp N``, ``--gp N`` or ``--pp N`` (one mode at a time, as in the root
harness; ``--pp_micro M``, default 2 * pp) times the mode's step with one
rank per process, under ``torchrun --standalone --nproc_per_node N -m
pyhgt_tpu_torch.bench ...`` (``--dist_backend gloo`` to share one card):
dp trains each data rank on its own batch (seeds 0..N-1), gp splits the one
batch's edges over the ranks, pp streams M batches through the stages.
Rank 0 prints the line, ``hgt_train_edges_per_s_<mode><N>``: the edges of
the step's batches x n_layers over the step time of rank 0.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

from pyhgt_tpu_torch import resolve_device
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.ops.sorted_hgt import EDGE_BWD
from pyhgt_tpu_torch.parallel import pipeline as ppl
from pyhgt_tpu_torch.parallel.mesh import GRAPH_AXIS, make_mesh, shard_model
from pyhgt_tpu_torch.parallel.spmd import (
    dp_value_and_grad,
    make_step,
    make_tp_norm,
)
from pyhgt_tpu_torch.train.optim import cosine_schedule, make_optimizer
from pyhgt_tpu_torch.train.step import TrainState, make_train_step


def make_flagship_trainer(fl, fused: bool = False):
    """``(state, step)`` for a flagship: the bench's optimizer over its
    model (``fused``: the flattened-vector AdamW) and ``step(batch, se,
    labels) -> loss``."""
    optimizer = _optimizer(fl.model.named_parameters(), fused)
    return TrainState(fl.model, optimizer), make_train_step(fl.loss, optimizer)


def _optimizer(named, fused: bool = False):
    return make_optimizer(named, cosine_schedule(1e-3, 1000),
                          weight_decay=0.01, clip_norm=0.25, fused=fused)


def parallel_trainer(fl, mode: str, n: int, n_micro: int = 0,
                     fused: bool = False):
    """``(value_and_grad, optimizer, args, n_edges)`` of one parallel mode
    on this rank: ``value_and_grad(*args)`` is the mode's forward,
    backward and reductions on the bench's batches (dp: the batch of seed =
    data index; gp: this rank's shard of the batch of seed 0; pp: the
    batches of seeds 0..M-1), ``optimizer`` the bench's over the
    parameters this rank trains, and ``n_edges`` the valid edges a step
    trains on. The world must have ``n`` ranks and ``fl`` a model built
    with ``graph_axis`` under gp. ``"tp"`` (no flag of the bench: the root
    harness has no tp mode) replaces ``fl.model`` by this rank's sharded
    copy, trained on the batch of seed 0 with the clip's norm read across
    the model group. ``fused`` selects the flattened-vector AdamW."""
    if mode == "pp":
        M = n_micro or 2 * n
        mesh = ppl.make_pipe_mesh(n)
        micro, n_edges = [], 0
        for seed in range(M):
            batch, labels = synth_flagship_batch(fl, seed=seed)
            n_edges += int(batch.edge_mask.sum())
            b, se, y = fl.to_device(batch, fl.sort(batch), labels)
            micro.append((b.node_feat, b.node_mask, se, None, y))
        loss_fn = ppl.make_pp_loss(fl, mesh, M)
        optimizer = _optimizer(loss_fn.stage.named_parameters(), fused)
        return (ppl.make_pp_value_and_grad(loss_fn, optimizer, mesh),
                optimizer, (fl.dropout_gen, micro), n_edges)
    if mode == "tp":
        mesh = make_mesh(n_data=1, n_model=n)
        fl.model = shard_model(fl.model, mesh)
        batch, labels = synth_flagship_batch(fl, seed=0)
        named = list(fl.model.named_parameters())
        optimizer = _optimizer(named, fused)
        optimizer.norm_fn = make_tp_norm(named, mesh)
        return (dp_value_and_grad(fl.loss, optimizer.params, mesh), optimizer,
                fl.to_device(batch, fl.sort(batch), labels),
                int(batch.edge_mask.sum()))
    mesh = (make_mesh(n_data=1, n_graph=n) if mode == "gp"
            else make_mesh(n_data=n))
    seed = mesh.index("data")
    batch, labels = synth_flagship_batch(fl, seed=seed)
    se = fl.sort(batch)
    if mode == "gp":
        se = fl.partition(se, n).local(mesh.index(GRAPH_AXIS),
                                       mesh.group(GRAPH_AXIS))
    optimizer = _optimizer(fl.model.named_parameters(), fused)
    n_edges = int(batch.edge_mask.sum()) * (n if mode == "dp" else 1)
    return (dp_value_and_grad(fl.loss, optimizer.params, mesh), optimizer,
            fl.to_device(batch, se, labels), n_edges)


def run(preset: str = "bench", steps: int = 10, warmup: int = 3, device=None,
        seed: int = 0, fused_opt: bool = False, **overrides) -> dict:
    """Time ``steps`` train steps after ``warmup`` and return the JSON
    record. ``device=None`` means ``cuda`` and raises without one;
    ``overrides`` replace fields of the preset's ``FlagshipConfig``;
    ``fused_opt`` selects the flattened-vector AdamW."""
    fl = build_flagship(preset, device=device, seed=seed, **overrides)
    batch, labels = synth_flagship_batch(fl, seed=0, edge_fill=1.0)
    n_edges = int(batch.edge_mask.sum())
    args = fl.to_device(batch, fl.sort(batch), labels)
    _, step = make_flagship_trainer(fl, fused_opt)
    metric = ("hgt_train_edges_per_s_per_chip" if fl.device.type == "cuda"
              else "hgt_train_edges_per_s_cpu")
    return _time(fl, step, args, n_edges, steps, warmup, metric, "chip")


def run_parallel(mode: str, n: int, preset: str = "bench", steps: int = 10,
                 warmup: int = 3, device=None, seed: int = 0, n_micro: int = 0,
                 fused_opt: bool = False, **overrides) -> dict:
    """:func:`run` for one parallel mode on this rank of an ``n``-rank
    world (:func:`parallel_trainer`); the record is rank 0's."""
    if mode == "gp":
        overrides["graph_axis"] = GRAPH_AXIS
    fl = build_flagship(preset, device=device, seed=seed, **overrides)
    value_and_grad, optimizer, args, n_edges = parallel_trainer(
        fl, mode, n, n_micro, fused_opt)
    step = make_step(value_and_grad, optimizer)
    cpu = "_cpu" if fl.device.type == "cpu" else ""
    return _time(fl, step, args, n_edges, steps, warmup,
                 f"hgt_train_edges_per_s_{mode}{n}{cpu}", f"{mode}{n} rank")


def _time(fl, step, args, n_edges, steps, warmup, metric, per):
    """Time ``steps`` calls of ``step(*args)`` after ``warmup`` and return
    the record (``per`` names what the rate is per)."""

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
        "metric": metric,
        "value": round(n_edges * n_layers / dt, 1),
        "unit": f"edges/s/{per} ({n_layers}-layer fwd+bwd+adamw, {n_edges} "
                f"edges/step, step {dt * 1e3:.1f} ms, {kind})",
    }


PROBE = ("import torch; x = torch.ones(8, 128, device='cuda') + 1; "
         "torch.cuda.synchronize(); print(float(x[0, 0]))")


def probe_device(timeout: int, retries: int, retry_sleep: int) -> str:
    """The root harness's bounded device probe: a subprocess adds to a
    small CUDA tensor and synchronizes within ``timeout`` seconds, tried
    ``1 + retries`` times ``retry_sleep`` seconds apart. Returns "" when
    it answered, else the last error."""
    err = ""
    for attempt in range(1 + max(retries, 0)):
        if attempt:
            time.sleep(retry_sleep)
        try:
            subprocess.run([sys.executable, "-c", PROBE], timeout=timeout,
                           check=True, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True)
            return ""
        except subprocess.TimeoutExpired:
            err = (f"device unreachable (a small CUDA op did not complete "
                   f"in {timeout} s)")
        except subprocess.CalledProcessError as e:
            tail = (e.stderr or "").strip().splitlines()[-1:]
            err = f"device probe failed: {e}{': ' + tail[0] if tail else ''}"
        print(f"probe attempt {attempt + 1} failed: {err}", file=sys.stderr)
    return err


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
    ap.add_argument("--fused_opt", action="store_true", default=False,
                    help="flattened-vector AdamW (train/optim.fused_adamw)")
    ap.add_argument("--param_bf16", action="store_true", default=None,
                    help="bf16 weight banks at apply time, f32 masters")
    ap.add_argument("--no-probe", dest="probe", action="store_false",
                    default=True,
                    help="skip the bounded device-reachability probe")
    ap.add_argument("--probe_timeout", type=int, default=420)
    ap.add_argument("--probe_retries", type=int, default=0,
                    help="extra probe attempts before giving up (the card "
                         "is local: none by default)")
    ap.add_argument("--probe_retry_sleep", type=int, default=300)
    for mode, what in (("dp", "data-parallel ranks, a batch each"),
                       ("gp", "graph-axis ranks: one batch's edges split "
                              "over them"),
                       ("pp", "pipeline stages (GPipe); n_layers % pp == 0")):
        ap.add_argument(f"--{mode}", type=int, default=1,
                        help=f"{what} (one process each, under torchrun)")
    ap.add_argument("--pp_micro", type=int, default=0,
                    help="pp microbatches per step (default 2 * pp)")
    ap.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                    help="torch.distributed backend (default nccl on a GPU; "
                         "gloo to put several ranks on one card)")
    args = ap.parse_args(argv)
    overrides = {k: getattr(args, k) for k in
                 ("edge_bf16", "edge_bwd", "seg_pallas", "softmax_pallas",
                  "param_bf16")
                 if getattr(args, k) is not None}
    modes = {m: getattr(args, m) for m in ("dp", "gp", "pp")
             if getattr(args, m) > 1}
    if len(modes) > 1:
        ap.error("--dp/--gp/--pp compose in the engine (python -m "
                 "pyhgt_tpu_torch.run); the bench times one mode at a time")
    # no GPU and no request for the CPU raises here, before any probe
    if args.probe and resolve_device(args.device).type == "cuda":
        err = probe_device(args.probe_timeout, args.probe_retries,
                           args.probe_retry_sleep)
        if err:
            print(f"ERROR: {err}", file=sys.stderr)
            return 2
    if not modes:
        print(json.dumps(run(args.preset, args.steps, args.warmup,
                             args.device, fused_opt=args.fused_opt,
                             **overrides)))
        return 0
    from pyhgt_tpu_torch.parallel.distributed import initialize

    (mode, n), = modes.items()
    info = initialize(args.dist_backend, args.device)
    if info["process_count"] != n:
        ap.error(f"--{mode} {n} needs {n} ranks: run torchrun --standalone "
                 f"--nproc_per_node {n} -m pyhgt_tpu_torch.bench ...")
    rec = run_parallel(mode, n, args.preset, args.steps, args.warmup,
                       info["device"], n_micro=args.pp_micro,
                       fused_opt=args.fused_opt, **overrides)
    if info["process_index"] == 0:
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
