"""CLI — ``python -m pyhgt_tpu_torch.run <task> --data <graph> [flags]``.

Counterpart of :mod:`pyhgt_tpu.run`: the same tasks, every
:class:`~pyhgt_tpu_torch.config.ExperimentConfig` field as a flag, and the
tasks' own flags, so a recipe of the JAX package translates unchanged.
Each task starts from its own preset (``serve`` from ``ogbn_mag``, or
from ``author_disambiguation`` under ``--serve_task link``; ``eval_ogbn_mag``
from ``ogbn_mag``). Ported tasks:

- ``paper_field`` / ``paper_venue``: train the OAG node classifier
  (:func:`~pyhgt_tpu_torch.experiments.engine.run_node_classification`;
  KL over the multi-hot L2 fields, NLL over the venue) with ``--features
  oag|mag`` and ``--label_meta``, then average NDCG/MRR over 10 test
  batches;
- ``author_disambiguation``: train the two-tower link matcher
  (:func:`~pyhgt_tpu_torch.experiments.engine.run_author_disambiguation`)
  with ``--first_meta`` / ``--write_meta``;
- ``ogbn_mag``: train (:func:`~pyhgt_tpu_torch.experiments.engine.run_ogbn`:
  the epoch loop, best and ``latest`` checkpoints and a metrics jsonl under
  ``--model_dir``), then evaluate the test
  split by ``--eval_mode`` (``variance_reduce`` or ``sequential``;
  ``--task_type`` is the reference's alias); ``--plot`` writes the curves
  PNG when matplotlib is installed;
- ``eval_ogbn_mag --ckpt <dir>``: evaluate a checkpoint
  (:func:`~pyhgt_tpu_torch.experiments.engine.evaluate_ogbn`);
- ``preprocess_oag --input_dir <tsv dir> --output_dir <dir>``: build the
  OAG graph from the raw TSVs
  (:func:`~pyhgt_tpu_torch.datasets.oag.preprocess_oag`, ``--domain``,
  ``--citation_bar``) and write it as a ``save_dir``;
- ``serve --ckpt <dir>``: JSON-lines requests on stdin answered on stdout
  (or HTTP with ``--http``) by an
  :class:`~pyhgt_tpu_torch.experiments.serving.OgbnPredictor`
  (``--serve_task node``), or by a
  :class:`~pyhgt_tpu_torch.experiments.serving.LinkPredictor` over an
  ``author_disambiguation`` checkpoint (``--serve_task link``: top-k
  authors of query papers from an index of the first ``--index_authors``
  grouped authors, 0 = all).

Every training run writes its best and ``latest`` checkpoints under
``--model_dir``; ``--plot`` writes the curves PNG when matplotlib is
installed. ``--conv_name`` picks the conv (hgt, dense_hgt, gcn, gat, rgcn,
han, hetgnn) and ``--edge_impl`` its edge path (``sorted`` or
``segment``). ``--data`` takes a ``save_dir``, a ``CSRGraph`` pickle of
either package or a graph pickled by the reference
(:func:`~pyhgt_tpu_torch.datasets.convert.convert_reference_pickle`).
``--device`` (default ``cuda``) takes the place of the JAX package's
``--platform``: without a GPU the default raises, ``--device cpu`` runs
the plain CPU path.

The training tasks take the parallel modes, one process per rank under
``torchrun``::

    torchrun --standalone --nproc_per_node <dp*gp*pp> -m pyhgt_tpu_torch.run \
        ogbn_mag --data <graph> --gp 2 [--dp N] [--pp N --pp_micro M] \
        [--gp_overlap] [--dist_backend nccl|gloo]

``--dist_backend`` is ``nccl`` by default on a GPU (one card per rank) and
``gloo`` on the CPU; ``gloo`` also lets several ranks share one card, which
NCCL refuses. Each rank runs on ``cuda:<LOCAL_RANK % cards>`` (or the
CPU); rank 0 logs, evaluates and writes the checkpoints, and every rank's
kernel launches are logged at the end. A world size other than
``dp * gp * pp`` raises with the torchrun line to use.
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
                   help="the port's checkpoint directory (eval_ogbn_mag / "
                        "serve)")
    p.add_argument("--eval_mode", "--task_type", dest="eval_mode",
                   default="variance_reduce",
                   choices=["variance_reduce", "sequential"],
                   help="eval protocol; --task_type is the reference "
                        "alias (eval_ogbn_mag.py:29-30)")
    p.add_argument("--plot", action="store_true",
                   help="write loss/metric curves PNG next to the "
                        "checkpoint after training (train_ogbn_mag.py:29)")
    p.add_argument("--input_dir", default="./data/oag_raw",
                   help="preprocess_oag: raw TSV directory "
                        "(preprocess_OAG.py:14)")
    p.add_argument("--output_dir", default="./data/oag_output",
                   help="preprocess_oag: save_dir for the built CSRGraph "
                        "(preprocess_OAG.py:16)")
    p.add_argument("--citation_bar", type=int, default=1,
                   help="preprocess_oag: keep papers with citations >= "
                        "min(2020-year, 20)*bar (preprocess_OAG.py:22)")
    p.add_argument("--features", default="oag", choices=["oag", "mag"],
                   help="feature extractor for OAG tasks (oag = node_emb||"
                        "emb||log-citation concat; mag = plain emb gather)")
    p.add_argument("--label_meta", default=None,
                   help="label meta-relation as 'tgt_type,src_type,rel' "
                        "(defaults: field,paper,PF_in_L2 for paper_field; "
                        "venue,paper,PV_Journal for paper_venue)")
    p.add_argument("--serve_task", default="node", choices=["node", "link"],
                   help="serve mode: node = classification over sampled "
                        "subgraphs; link = two-tower matcher top-k "
                        "(offline author index + online paper queries)")
    p.add_argument("--coalesce_wait", default=0.0,
                   type=lambda s: s if s == "auto" else float(s),
                   help="serve micro-batching (node and link): wait this "
                        "many seconds after the first pending request, then "
                        "answer the burst with one coalesced model call; "
                        "'auto' (or a "
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
    p.add_argument("--index_authors", type=int, default=0,
                   help="link-serve: pre-build the candidate index over the "
                        "first N grouped authors (0 = all); clients can "
                        "rebuild online with an index_authors request line")
    p.add_argument("--first_meta", default=None,
                   help="link family: first-author meta-relation as "
                        "'tgt,src,rel' (default author,paper,"
                        "rev_AP_write_first — the OAG schema, "
                        "train_author_disambiguation.py:79-86)")
    p.add_argument("--write_meta", default=None,
                   help="link family: authorship meta-relation as "
                        "'tgt,src,rel' (default paper,author,AP_write_first)")
    p.add_argument("--data", dest="data_path", default=None,
                   help="CSRGraph pickle or a save_dir directory "
                        "(mmap-loaded); either may come from the JAX "
                        "package; a graph pickled by the reference is "
                        "converted")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda, which "
                        "raises without a GPU; 'cpu' runs the plain path)")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend of the parallel modes "
                        "(default nccl on a GPU, gloo on the CPU; gloo to "
                        "put several ranks on one card)")
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
    module-mapping unpickler of :mod:`pyhgt_tpu_torch.graph.csr`); any
    other pickle is read as the reference's graph and converted
    (:func:`~pyhgt_tpu_torch.datasets.convert.convert_reference_pickle`),
    as the JAX package does."""
    if os.path.isdir(path):
        return CSRGraph.load_dir(path, mmap=True)
    try:
        return CSRGraph.load(path)
    except Exception:
        from pyhgt_tpu_torch.datasets.convert import convert_reference_pickle

        return convert_reference_pickle(path)


def _link_metas(args) -> dict:
    """--first_meta/--write_meta 'tgt,src,rel' -> kwargs for the link
    family (training runner + LinkPredictor), defaults omitted."""
    out = {}
    if args.first_meta:
        out["first_meta"] = tuple(args.first_meta.split(","))
    if args.write_meta:
        out["write_meta"] = tuple(args.write_meta.split(","))
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.task == "preprocess_oag":
        # the reference's preprocess_OAG.py surface: raw TSVs in, the
        # built graph out as a save_dir (memory-mapped on load)
        from pyhgt_tpu_torch.datasets.oag import preprocess_oag

        domain = args.domain if args.domain is not None else "_CS"
        g = preprocess_oag(args.input_dir, domain=domain,
                           citation_bar=args.citation_bar)
        g.save_dir(args.output_dir)
        print(f"saved CSRGraph save_dir to {args.output_dir}")
        return 0
    if not args.data_path:
        raise SystemExit(f"--data is required for task {args.task!r}")
    if args.task in ("eval_ogbn_mag", "serve") and not args.ckpt:
        raise SystemExit(f"--ckpt required for {args.task}")
    if args.task == "eval_ogbn_mag":
        preset = "ogbn_mag"
    elif args.task == "serve":
        # the predictor rebuilds the training model before restoring the
        # checkpoint, so the preset is the task's that wrote it
        preset = ("author_disambiguation" if args.serve_task == "link"
                  else "ogbn_mag")
    else:
        preset = args.task
    cfg = PRESETS[preset]
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    overrides = {k: v for k, v in vars(args).items()
                 if k in fields and v is not None}
    cfg = cfg.replace(**overrides)

    from pyhgt_tpu_torch.utils.experiment import args_print

    # serve keeps stdout a pure JSON-lines channel: every log line goes to
    # stderr so clients can json.loads each stdout line
    out_file = sys.stderr if args.task == "serve" else sys.stdout
    log = lambda s: print(s, file=out_file, flush=True)  # noqa: E731
    args_print(dataclasses.asdict(cfg), file=out_file)
    graph = load_graph(cfg.data_path)

    if args.task in ("paper_field", "paper_venue", "author_disambiguation",
                     "ogbn_mag"):
        args.device = start_world(cfg, args)
        out = train(args, cfg, graph, log)
        report_launches(log)
        if args.plot:
            plot(out["history"], cfg)
    elif args.task == "eval_ogbn_mag":
        from pyhgt_tpu_torch.experiments.engine import evaluate_ogbn

        evaluate_ogbn(cfg, graph, args.ckpt, eval_mode=args.eval_mode,
                      log=log, device=args.device)
    elif args.serve_task == "link":
        serve_link(args, cfg, graph, log)
    else:
        from pyhgt_tpu_torch.experiments.serving import (
            OgbnPredictor,
            node_answer,
            serve_http,
            serve_jsonl,
        )

        pred = OgbnPredictor(cfg, graph, args.ckpt, log=log,
                             device=args.device)
        if args.http:
            serve_http(node_answer(pred), port=args.http,
                       log=log).serve_forever()
        else:
            serve_jsonl(pred, log=log, coalesce_wait=args.coalesce_wait,
                        deadline_ms=args.deadline_ms)
    return 0


def start_world(cfg: ExperimentConfig, args) -> str:
    """Join the process group of a parallel run (``dp * gp * pp`` ranks,
    one per process, under torchrun) and return this rank's device; a
    single-process run starts nothing. A world of another size raises,
    with the torchrun line to use."""
    from pyhgt_tpu_torch.parallel.distributed import initialize

    need = max(cfg.dp, 1) * max(cfg.gp, 1) * max(cfg.pp, 1)
    have = int(os.environ.get("WORLD_SIZE", "1"))
    if need != have:
        raise SystemExit(
            f"dp x gp x pp = {need} ranks but the world has {have}: run "
            f"torchrun --standalone --nproc_per_node {need} -m "
            f"pyhgt_tpu_torch.run {' '.join(sys.argv[1:])}")
    info = initialize(args.dist_backend, args.device)
    if info["backend"] and info["process_index"] == 0:
        print(f"dist: {have} ranks, backend {info['backend']}, rank 0 on "
              f"{info['device']}", flush=True)
    return str(info["device"])


def report_launches(log) -> None:
    """Log every rank's kernel launches (rank 0 gathers them) when the run
    has more than one rank."""
    import torch.distributed as dist

    from pyhgt_tpu_torch.ops import pallas_seg as ps

    if not (dist.is_available() and dist.is_initialized()):
        return
    pair, slab = ps.live_partials_pair, ps.live_partials_slab
    mine = {"live_partials": ps.live_partials.launches,
            "pair_runs": pair.launches - pair.window_launches,
            "pair_window": pair.window_launches,
            "slab_runs": slab.launches - slab.window_launches,
            "slab_window": slab.window_launches,
            "weighted": ps.live_partials_weighted.launches,
            "softmax": ps.segment_softmax_partials.launches,
            "head_sum": ps.head_sum_product.launches}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if dist.get_rank() == 0:
        log("kernel launches per rank " + json.dumps(every))
    dist.barrier()
    dist.destroy_process_group()


def train(args, cfg: ExperimentConfig, graph, log) -> dict:
    """Run the training task ``args.task`` on ``args.device``."""
    from pyhgt_tpu_torch.experiments import engine

    if args.task == "ogbn_mag":
        return engine.run_ogbn(cfg, graph, log=log, eval_mode=args.eval_mode,
                               device=args.device)
    if args.task == "author_disambiguation":
        return engine.run_author_disambiguation(
            cfg, graph, log=log, device=args.device, **_link_metas(args))
    from pyhgt_tpu_torch.datasets.features import feature_mag, feature_oag

    field = args.task == "paper_field"
    default = (("field", "paper", "PF_in_L2") if field
               else ("venue", "paper", "PV_Journal"))
    label_meta = (tuple(args.label_meta.split(",")) if args.label_meta
                  else default)
    return engine.run_node_classification(
        cfg, graph, label_meta=label_meta, multi_label=field,
        feature_fn=feature_oag if args.features == "oag" else feature_mag,
        log=log, device=args.device)


def serve_link(args, cfg: ExperimentConfig, graph, log) -> None:
    """``serve --serve_task link``: a LinkPredictor over the checkpoint,
    its index built over the grouped authors (the first
    ``--index_authors``), then JSON-lines or HTTP."""
    from pyhgt_tpu_torch.experiments.serving import (
        LinkPredictor,
        link_answer,
        serve_http,
        serve_link_jsonl,
    )

    lp = LinkPredictor(cfg, graph, args.ckpt, log=log, device=args.device,
                       **_link_metas(args))
    authors = sorted(a for g in lp.task.groups.values() for a in g)
    if args.index_authors > 0:
        authors = authors[: args.index_authors]
    log(f"indexing {len(authors)} candidate authors")
    lp.build_author_index(authors)
    if args.http:
        serve_http(link_answer(lp), port=args.http, log=log).serve_forever()
    else:
        serve_link_jsonl(lp, log=log, coalesce_wait=args.coalesce_wait,
                         deadline_ms=args.deadline_ms)


def plot(history, cfg: ExperimentConfig) -> None:
    """The curves PNG next to the checkpoints; without matplotlib, say so
    (the training run has finished and its checkpoints stand)."""
    from pyhgt_tpu_torch.utils.experiment import plot_history

    png = os.path.join(cfg.model_dir, f"{cfg.task_name}_curves.png")
    try:
        print(f"plot: {plot_history(history, png)}")
    except ImportError as e:
        print(f"plot: not written, matplotlib is not installed ({e})")


if __name__ == "__main__":
    sys.exit(main())
