"""CLI — ``python -m pyhgt_tpu_torch.run serve --data <graph> --ckpt <dir>``.

Counterpart of :mod:`pyhgt_tpu.run`: the same tasks, every
:class:`~pyhgt_tpu_torch.config.ExperimentConfig` field as a flag, and the
serve task's flags, so a serve recipe of the JAX package translates
unchanged. What is ported is the ``serve`` task with ``--serve_task node``:
JSON-lines requests on stdin answered on stdout (or HTTP with ``--http``)
by an :class:`~pyhgt_tpu_torch.experiments.serving.OgbnPredictor` on the
``ogbn_mag`` preset. Every other task exits with "not ported yet".
``--device`` (default ``cuda``) takes the place of the JAX package's
``--platform``: without a GPU the default raises, ``--device cpu`` runs the
plain CPU path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from pyhgt_tpu_torch.config import PRESETS, ExperimentConfig
from pyhgt_tpu_torch.graph.csr import CSRGraph


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pyhgt_tpu_torch.run",
                                description=__doc__.splitlines()[0])
    p.add_argument(
        "task",
        choices=list(PRESETS.keys())
        + ["eval_ogbn_mag", "serve", "preprocess_oag"],
    )
    p.add_argument("--ckpt", default=None,
                   help="serve: the port's checkpoint directory")
    p.add_argument("--serve_task", default="node", choices=["node", "link"],
                   help="serve mode: node = classification over sampled "
                        "subgraphs; link = two-tower matcher top-k "
                        "(not ported yet)")
    p.add_argument("--coalesce_wait", default=0.0,
                   type=lambda s: s if s == "auto" else float(s),
                   help="serve micro-batching: wait this many seconds after "
                        "the first pending request, then answer the burst "
                        "with one coalesced model call; 'auto' (or a "
                        "negative value = adaptive with that max window) "
                        "adapts the window to the arrival process "
                        "(serving.AdaptiveWait)")
    p.add_argument("--deadline_ms", type=float, default=None,
                   help="serve (adaptive coalescing): arrival-anchored "
                        "p95 queueing cap — the burst is answered once "
                        "its oldest request has waited this long, "
                        "however deep the backlog")
    p.add_argument("--http", type=int, default=0, metavar="PORT",
                   help="serve over HTTP on this port instead of "
                        "JSON-lines stdio (POST / with the same request "
                        "bodies; GET /healthz)")
    p.add_argument("--data", dest="data_path", default=None,
                   help="CSRGraph pickle or a save_dir directory "
                        "(mmap-loaded); either may come from the JAX "
                        "package")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda, which "
                        "raises without a GPU; 'cpu' runs the plain path)")
    ref = ExperimentConfig()
    for f in dataclasses.fields(ExperimentConfig):
        if f.name == "data_path":
            continue
        arg = "--" + f.name
        if f.type == "bool" or isinstance(getattr(ref, f.name), bool):
            p.add_argument(arg, action=argparse.BooleanOptionalAction,
                           default=None)
        else:
            p.add_argument(arg, type=type(getattr(ref, f.name))
                           if getattr(ref, f.name) is not None else int,
                           default=None)
    # reference-compatible aliases
    p.add_argument("--use_RTE", dest="use_rte",
                   action=argparse.BooleanOptionalAction, default=None)
    return p


def load_graph(path: str):
    """A ``save_dir`` directory (memory-mapped) or a ``CSRGraph`` pickle,
    either written by this package or by the JAX package (read through the
    module-mapping unpickler of :mod:`pyhgt_tpu_torch.graph.csr`)."""
    if os.path.isdir(path):
        return CSRGraph.load_dir(path, mmap=True)
    return CSRGraph.load(path)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.task != "serve" or args.serve_task != "node":
        what = (args.task if args.task != "serve"
                else f"serve --serve_task {args.serve_task}")
        raise SystemExit(f"pyhgt_tpu_torch.run: {what} is not ported yet "
                         "(only serve --serve_task node is)")
    if not args.data_path:
        raise SystemExit("--data is required for task 'serve'")
    if not args.ckpt:
        raise SystemExit("--ckpt required for serve")
    cfg = PRESETS["ogbn_mag"]
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    overrides = {k: v for k, v in vars(args).items()
                 if k in fields and v is not None}
    cfg = cfg.replace(**overrides)

    from pyhgt_tpu_torch.experiments.serving import (
        OgbnPredictor,
        node_answer,
        serve_http,
        serve_jsonl,
    )

    # stdout is the JSON-lines response channel — every log line goes to
    # stderr so clients can json.loads each stdout line
    err = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    err("config " + json.dumps(dataclasses.asdict(cfg)))
    graph = load_graph(cfg.data_path)
    pred = OgbnPredictor(cfg, graph, args.ckpt, log=err, device=args.device)
    if args.http:
        serve_http(node_answer(pred), port=args.http, log=err).serve_forever()
    else:
        serve_jsonl(pred, log=err, coalesce_wait=args.coalesce_wait,
                    deadline_ms=args.deadline_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
