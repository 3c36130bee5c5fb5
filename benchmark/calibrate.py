"""The readings that the limits of ``correct`` are set from, at a cell's
own size, on the card: for each seed the numbers of the program's first
steps against the plain reference (the lower readings), and on the first
``--faults`` seeds those of the control and of a planted fault, each put in
the program's place against the same reference (the upper readings):

- ``control_tf32``: the reference with every node product's inputs
  rounded to TF32, the precision below the configuration's float32;
- ``control_fp8``: the reference with its edge stage at fp8 e4m3, the
  precision below the configuration's bfloat16;
- ``half_batch``: the reference with the second half of each batch's live
  label rows left out, the mean taken over the rest;

and, beside them, ``program_again``: the program's first steps run a
second time from the same seed, against the first run (the floor that
the card's unordered sums set).

A step that returns its state unchanged reads 1 on ``update_norm_gap``
and ``grad_norm_gap`` by their definition, and needs no run.

    python3 -m benchmark.calibrate --workload hgt-ogbn-mag.train \\
        --seeds 11,12,13 --faults 3 > readings.jsonl

One JSON line per seed on standard output. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import check, reference, session, spec, system, weights
from benchmark.reference import train as ref_train


def readings(cell, seed: int, graph, device, faults: bool, log) -> dict:
    cfg, traffic = cell.config, cell.traffic
    t0 = time.perf_counter()
    sut = system.build(cfg, seed, device, log, graph=graph)
    step, step_seed = session.stepper(sut, device)
    n = traffic["check_steps"]
    firsts, prog = session.first_steps(sut, traffic, seed, step, n)
    names_shapes = weights.names_shapes(sut.model)
    node_cap, blocks = sut.layout.node_cap, sut.layout_blocks()
    plain = system.plain_graph(sut.graph)
    del sut, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    batches, bad = session.reference_batches(cfg, plain, firsts, node_cap,
                                             blocks)
    params0 = weights.draw(names_shapes, seed, device)
    seeds = [step_seed(k) for k in range(n)]

    def ref_run(**kw):
        return ref_train.run_steps(params0, batches, seeds, cfg,
                                   plain["metas"], device, **kw)

    ref = ref_run()
    t2 = time.perf_counter()
    out = dict(seed=seed, program=check.numbers(prog, ref, bad),
               losses=dict(program=prog["losses"], reference=ref["losses"]),
               seconds=dict(program=t1 - t0, reference=t2 - t1))
    if faults:
        for c in reference.for_config(cfg).CONTROLS:
            out[f"control_{c}"] = check.numbers(ref_run(control=c), ref, 0)
        out["half_batch"] = check.numbers(ref_run(half_batch=True), ref, 0)
        # the program against itself: the same weights, batches and
        # dropout streams again (the card's unordered sums alone differ)
        del params0, batches
        sut = system.build(cfg, seed, device, log, graph=graph)
        step, _ = session.stepper(sut, device)
        _, again = session.first_steps(sut, traffic, seed, step, n)
        out["program_again"] = check.numbers(again, prog, 0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--faults", type=int, default=3,
                   help="how many of the seeds also read the control and "
                        "the planted fault")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = spec.load_cell(args.workload)
    device = torch.device(args.device)
    graph = system.make_graph(cell.config, device)
    for i, s in enumerate(int(x) for x in args.seeds.split(",")):
        line = readings(cell, s, graph, device, i < args.faults, log)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
