"""Shared experiment engine: task assembly, epoch loop, evaluation.

Counterpart of the single-device path of
:mod:`pyhgt_tpu.experiments.engine`: ``make_sampler``, ``make_layout``,
``gnn_kwargs``, ``make_tx``, ``_infer_in_dim``, the producer-side train
item (``_Item``, ``_make_producer``), ``make_exec`` at dp = tp = gp = pp = 1,
``_warn_overflow``, the OAG split ``OAG_SPLITS``, ``_probe_in_dim``, the
three runners :func:`run_node_classification` (paper-field / paper-venue),
:func:`run_author_disambiguation` and :func:`run_ogbn`, and the standalone
checkpoint evaluation :func:`evaluate_ogbn`; plus ``node_classifier`` and
``link_matcher`` (the models the JAX package builds inline) and
``check_ported``.

Epoch-loop parity (``OAG/train_paper_field.py:218-327``,
``ogbn-mag/train_ogbn_mag.py:130-215``): per epoch, ``n_batch`` training
batches (each trained on ``repeat`` times) plus validation; the validation
score (NDCG on the OAG tasks, accuracy on ogbn-mag) gates best-model
checkpointing; after training, the OAG tasks average NDCG/MRR over 10
resampled test batches, ogbn-mag evaluates the test split by the
variance-reduced protocol (``eval_ogbn_mag.py:128-179``). Sampling and the
host sort overlap training through
:class:`~pyhgt_tpu_torch.train.loader.PrefetchLoader`. One epoch loop
(:func:`_fit`, over :func:`_train_epoch`) serves the three runners, and
:func:`link_setup` builds the link task and model for the runner and for
serving.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pyhgt_tpu_torch import resolve_device
from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.graph.schema import PadSpec
from pyhgt_tpu_torch.models.composite import (
    LinkMatcherModel,
    NodeClassifierModel,
)
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.sampling.batch import BatchLayout
from pyhgt_tpu_torch.sampling.hgsampler import HGSampler
from pyhgt_tpu_torch.sampling.sorted_batch import (
    SortedEdges,
    sort_batch,
    sort_edges,
)
from pyhgt_tpu_torch.tasks.base import (
    TaskBatch,
    TimeSplit,
    build_time_split_pairs,
    subsample_pairs,
)
from pyhgt_tpu_torch.tasks.evaluate import multi_sample_eval
from pyhgt_tpu_torch.tasks.link_prediction import (
    LinkPredictionTask,
    build_link_pairs,
    build_name_groups,
    make_link_loss_fn,
)
from pyhgt_tpu_torch.tasks.node_classification import NodeClassificationTask
from pyhgt_tpu_torch.tasks.ogbn import OgbnNodeTask
from pyhgt_tpu_torch.train.checkpoint import (
    BestCheckpointPolicy,
    load_checkpoint,
    save_checkpoint,
)
from pyhgt_tpu_torch.train.loader import PrefetchLoader
from pyhgt_tpu_torch.train.log import MetricsLogger
from pyhgt_tpu_torch.train.metrics import ranking_metrics
from pyhgt_tpu_torch.train.optim import (
    cosine_schedule,
    cosine_torch_schedule,
    make_optimizer,
    onecycle_schedule,
)
from pyhgt_tpu_torch.train.step import (
    TrainState,
    make_eval_step,
    make_train_step,
)
from pyhgt_tpu_torch.utils.experiment import get_n_params

# the reference's temporal split: train<2015 / 2015<=valid<=2016 / test>2016
# (OAG/train_paper_field.py:74-76)
OAG_SPLITS = {
    "train": TimeSplit(hi=2014),
    "valid": TimeSplit(lo=2015, hi=2016),
    "test": TimeSplit(lo=2017),
}


def check_ported(cfg: ExperimentConfig) -> None:
    """Raise on a configuration the port cannot run yet (the parallel modes
    and bf16 weight banks) instead of running another one."""
    for knob in ("dp", "tp", "gp", "pp"):
        if getattr(cfg, knob) > 1:
            raise NotImplementedError(
                f"{knob} = {getattr(cfg, knob)}: the parallel modes are not "
                "ported yet")
    if cfg.param_bf16:
        raise NotImplementedError("param_bf16 is not ported yet")


def make_sampler(cfg: ExperimentConfig, graph: CSRGraph, log=print):
    if cfg.native_sampler:
        try:
            from pyhgt_tpu_torch.sampling.native import NativeHGSampler

            return NativeHGSampler(
                graph, depth=cfg.sample_depth, width=cfg.sample_width
            )
        except Exception as e:
            # the numpy sampler is 6-7x slower — never fall back silently
            msg = f"native sampler unavailable, using numpy fallback: {e!r}"
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
            log(f"WARNING: {msg}")
    return HGSampler(graph, depth=cfg.sample_depth, width=cfg.sample_width)


def make_layout(
    cfg: ExperimentConfig,
    graph: CSRGraph,
    sampler=None,
    seeds_fn=None,
) -> BatchLayout:
    if cfg.calibrate_caps and sampler is not None and seeds_fn is not None:
        # size per-meta edge caps from measured draws (PadSpec.calibrate);
        # overflow beyond the cap is subsampled by pad_sample anyway
        pad = PadSpec.calibrate(sampler, seeds_fn)
        if cfg.node_cap:
            pad = dataclasses.replace(pad, node_cap=cfg.node_cap)
        return BatchLayout(schema=graph.schema, pad=pad)
    node_cap = cfg.node_cap or (
        cfg.batch_size + cfg.sample_depth * cfg.sample_width
    )
    edge_cap = cfg.edge_cap or node_cap * 8
    pad = PadSpec.for_sampler(
        num_seeds=cfg.batch_size,
        depth=cfg.sample_depth,
        width=cfg.sample_width,
        schema=graph.schema,
        default_edge_cap=edge_cap,
    )
    if cfg.node_cap:
        pad = dataclasses.replace(pad, node_cap=cfg.node_cap)
    return BatchLayout(schema=graph.schema, pad=pad)


def gnn_kwargs(cfg: ExperimentConfig, layout: BatchLayout, in_dim: int) -> dict:
    """:class:`~pyhgt_tpu_torch.models.model.GNN`'s arguments. The JAX
    package's ``remat``, ``edge_impl``, ``graph_axis`` and ``gp_overlap``
    have no counterpart here (the port runs the sorted edge path on one
    device); a conv other than HGT raises."""
    if cfg.conv_name != "hgt":
        raise NotImplementedError(
            f"conv_name {cfg.conv_name!r}: only the HGT conv is ported yet")
    return dict(
        in_dim=in_dim,
        n_hid=cfg.n_hid,
        num_types=layout.num_types,
        num_relations=layout.schema.num_relations,
        n_heads=cfg.n_heads,
        n_layers=cfg.n_layers,
        dropout=cfg.dropout,
        prev_norm=cfg.prev_norm,
        last_norm=cfg.last_norm,
        use_rte=cfg.use_rte,
        save_kv=cfg.save_kv,
        edge_bf16=cfg.edge_bf16,
        edge_bwd=cfg.edge_bwd,
        seg_pallas=cfg.seg_pallas,
        softmax_pallas=cfg.softmax_pallas,
        softmax_tilemax=cfg.softmax_tilemax,
    )


def _generator(cfg: ExperimentConfig, seed: Optional[int]):
    return torch.Generator().manual_seed(cfg.seed if seed is None else seed)


def node_classifier(cfg: ExperimentConfig, layout: BatchLayout, in_dim: int,
                    n_classes: int, target_type: str = "paper",
                    seed: Optional[int] = None, head_mode: str = "full"):
    """The ``NodeClassifierModel`` of ``cfg`` on the CPU, with weights drawn
    from ``seed`` (default ``cfg.seed``): ``head_mode="full"`` is the
    ogbn-mag head, ``"seeds"`` the paper-field / paper-venue head over the
    first ``cfg.batch_size`` rows."""
    return NodeClassifierModel(
        gnn_kwargs(cfg, layout, in_dim), n_classes=n_classes,
        target_type_id=layout.schema.type_id(target_type),
        head_mode=head_mode,
        n_seed=cfg.batch_size if head_mode == "seeds" else 0,
        generator=_generator(cfg, seed),
    )


def link_matcher(cfg: ExperimentConfig, layout: BatchLayout, in_dim: int,
                 query_type: str = "paper", seed: Optional[int] = None):
    """The author-disambiguation ``LinkMatcherModel`` of ``cfg`` (queries:
    the first ``cfg.batch_size`` rows of ``query_type``) on the CPU, with
    weights drawn from ``seed`` (default ``cfg.seed``)."""
    return LinkMatcherModel(
        gnn_kwargs(cfg, layout, in_dim), n_hid=cfg.n_hid,
        query_type_id=layout.schema.type_id(query_type),
        n_query=cfg.batch_size, generator=_generator(cfg, seed),
    )


def make_tx(cfg: ExperimentConfig, named_params, steps_per_epoch: int):
    """The optimizer of ``cfg`` over a model's ``named_parameters()``:
    :func:`~pyhgt_tpu_torch.train.optim.make_optimizer` with the
    configured schedule, weight decay and clip."""
    if cfg.scheduler == "onecycle":
        # torch total_steps = n_batch*n_epoch + 1 (train_ogbn_mag.py:129)
        sched = onecycle_schedule(
            max_lr=cfg.max_lr,
            total_steps=max(cfg.n_epoch * steps_per_epoch, 1) + 1,
            pct_start=cfg.onecycle_pct_start,
            final_div_factor=cfg.onecycle_final_div,
            anneal=cfg.onecycle_anneal,
        )
    elif cfg.scheduler == "cosine_torch":
        # exact reference OAG dynamics: oscillating cos, train_step=1500
        # mid-cycle start (train_paper_field.py:205-212)
        sched = cosine_torch_schedule(cfg.max_lr, period=1000)
    elif cfg.scheduler == "cosine":
        sched = cosine_schedule(cfg.max_lr, period=1000)
    else:
        raise ValueError(
            f"unknown scheduler {cfg.scheduler!r} "
            "(cosine | cosine_torch | onecycle)"
        )
    return make_optimizer(named_params, sched, weight_decay=cfg.weight_decay,
                          clip_norm=cfg.clip, name=cfg.optimizer)


def _infer_in_dim(task_batch) -> int:
    return int(task_batch.sub.node_feat.shape[-1])


def _probe_in_dim(task, pairs, splits) -> int:
    tb = task.sample(pairs, splits["train"], np.random.default_rng(0))
    return _infer_in_dim(tb)


def sorted_logprobs(forward, node_feat, node_mask, se: SortedEdges, em_dev,
                    device) -> np.ndarray:
    """Host log-probs of one sorted batch through ``forward`` (a
    :func:`~pyhgt_tpu_torch.train.step.make_eval_step` of the model): the
    node features and mask and ``se`` to ``device``, the forward, the
    result back on the host."""
    return forward(
        torch.as_tensor(node_feat, device=device),
        torch.as_tensor(node_mask, device=device),
        se.to(device), em_dev,
    ).cpu().numpy()


@dataclasses.dataclass
class _Item:
    """Producer-side train item: task batch + SortedEdges + host scalars.

    The sort runs on the loader's worker threads (the C++ batch prep with
    the backward's aux takes 16-25 ms a batch at the ``ogbn_mag`` preset)
    so the consumer loop does no host work between steps;
    ``n_edges``/``overflow`` are counted on the host so the loop need not
    read an [E]-sized mask back from the device.
    """

    tb: TaskBatch
    se: SortedEdges
    n_edges: int
    overflow: int


def _make_producer(sample_fn, layout, em, tgt_rank_cap: int = 0,
                   src_rank_cap: int = 0, tab_cap: int = 0,
                   src_split_cap: int = 0):
    """``fn(rng) -> _Item``: ``sample_fn(rng)``, then the host sort with
    the backward's aux and the configured caps (the JAX package's producer
    at gp = 1; its graph-axis partition is not ported yet)."""

    def fn(rng):
        tb = sample_fn(rng)
        se = sort_batch(tb.sub, layout, em, tgt_rank_cap=tgt_rank_cap,
                        src_rank_cap=src_rank_cap, tab_cap=tab_cap,
                        src_split_cap=src_split_cap)
        return _Item(
            tb, se,
            int(np.asarray(tb.sub.edge_mask).sum()),
            int(np.asarray(tb.sub.block_overflow).sum()),
        )

    return fn


def _producer_for(cfg: ExperimentConfig, sample_fn, layout, em):
    """:func:`_make_producer` with ``cfg``'s aux caps."""
    return _make_producer(sample_fn, layout, em,
                          tgt_rank_cap=cfg.tgt_rank_cap,
                          src_rank_cap=cfg.src_rank_cap, tab_cap=cfg.tab_cap,
                          src_split_cap=cfg.src_split_cap)


def _staged(producer):
    """``producer`` whose item's SortedEdges are already in the form the
    step reads (:meth:`SortedEdges.to` on the CPU: int32 indices, each
    kernel aux checked), still on the worker thread; the loader moves it
    to the device."""
    cpu = torch.device("cpu")

    def fn(rng):
        item = producer(rng)
        return dataclasses.replace(item, se=item.se.to(cpu))

    return fn


def make_exec(cfg: ExperimentConfig, loss_fn, tx, state):
    """The train step for ``cfg``: the single-device branch of the JAX
    package's ``make_exec`` (dp = tp = gp = pp = 1). Returns ``(step,
    loader_kwargs, state, mesh)`` as it does, the last two unchanged and
    ``None``; the parallel modes raise (:func:`check_ported`)."""
    check_ported(cfg)
    return make_train_step(loss_fn, tx), {}, state, None


def _warn_overflow(log, overflow: int, edges: int, threshold: float = 0.01):
    """Surface silent edge-cap drops: any overflow is logged into the
    metrics jsonl by the caller; past the threshold fraction it also warns
    loudly — dropped edges quietly depress accuracy (cf. the sampler's
    induced-subgraph semantics, ``pyHGT/data.py:191-209``, which never
    drops edges)."""
    attempted = edges + overflow  # `edges` counts only KEPT edges
    if overflow and attempted and overflow / attempted > threshold:
        log(
            f"WARNING: edge caps dropped {overflow} of {attempted} sampled "
            f"edges this epoch ({100.0 * overflow / attempted:.1f}%); raise "
            f"edge_cap or enable calibrate_caps"
        )


# the name of the runners' profiler span over an epoch's train steps
TRAIN_SPAN = "engine.train_steps"


def _step_mark(device):
    """A point on the device's timeline after the work queued so far: a
    recorded CUDA event, or on the CPU (where a step runs synchronously)
    the host clock."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms_between(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def _restore_latest(cfg: ExperimentConfig, state: TrainState, resume: bool,
                    log):
    """The best-valid policy and the ``latest`` path of ``cfg``'s run, and,
    under ``resume``, ``state`` restored from ``latest`` when it exists.
    Returns ``(state, start_epoch, policy, latest_path)``."""
    prefix = os.path.join(cfg.model_dir, f"{cfg.task_name}_{cfg.conv_name}")
    latest_path = f"{prefix}_latest"
    start_epoch = 0
    if resume and os.path.exists(latest_path):
        state = load_checkpoint(latest_path, state)
        start_epoch = int(state.step) // (cfg.n_batch * cfg.repeat)
        log(f"resumed from {latest_path} at epoch {start_epoch}")
    return state, start_epoch, BestCheckpointPolicy(prefix), latest_path


def _train_epoch(step, it, cfg: ExperimentConfig, epoch: int, gen, dev,
                 step_args):
    """One epoch's ``n_batch * repeat`` steps on the loader's items:
    ``step(gen, *step_args(item))`` with ``gen`` reseeded per step as the
    JAX package keys its step (``epoch * 10000 + b``). The losses stay on
    the device until the epoch's steps are queued, then are read once.

    Returns ``(train_loss, edges, overflow, timing)``; ``timing`` holds
    ``step_ms`` (mean) and ``step_ms_max`` over the steps after the first
    (the interval between the ends of consecutive steps on the device's
    timeline) and ``wait_ms``, the consumer's mean wait on the loader per
    step (host clock)."""
    n_steps = cfg.n_batch * cfg.repeat
    losses, marks = [], []
    edges = overflow = 0
    wait = 0.0
    # a profiler span over the epoch's steps, up to the read of their
    # losses (a trace's idle share is read within it)
    with torch.profiler.record_function(TRAIN_SPAN):
        for b in range(n_steps):
            tw = time.perf_counter()
            item = next(it)
            wait += time.perf_counter() - tw
            edges += item.n_edges
            overflow += item.overflow
            gen.manual_seed(epoch * 10000 + b)
            losses.append(step(gen, *step_args(item)))
            marks.append(_step_mark(dev))
        # the one read of the epoch's losses (it waits for the device)
        train_loss = float(np.mean(
            torch.stack(losses).cpu().numpy().astype(np.float64)))
    step_ms = [_ms_between(a, b) for a, b in zip(marks, marks[1:])]
    timing = dict(
        step_ms=float(np.mean(step_ms)) if step_ms else None,
        step_ms_max=float(np.max(step_ms)) if step_ms else None,
        wait_ms=wait * 1e3 / n_steps)
    return train_loss, edges, overflow, timing


# the epoch log line's name of each validation field
_VALID_TEXT = {"valid_ndcg": "NDCG", "valid_mrr": "MRR", "valid_acc": "acc"}


def _fit(cfg: ExperimentConfig, producer, step, step_args, loader_kw,
         validate, state, start_epoch: int, ckpt, latest_path: str, dev,
         log, metrics=None) -> list:
    """The runners' epoch loop, from ``start_epoch`` to ``cfg.n_epoch``:
    :func:`_train_epoch` on a :class:`PrefetchLoader` over ``producer``,
    then ``validate()`` (the epoch's validation fields, a dict whose first
    value gates the best checkpoint), the best and ``latest`` checkpoints,
    the history record (also to ``metrics`` when given), the overflow
    warning and the epoch's log line. Returns the history."""
    history = []
    gen = torch.Generator(device=dev)
    with _loader(producer, cfg, dev, loader_kw) as loader:
        it = iter(loader)
        for epoch in range(start_epoch, cfg.n_epoch):
            t0 = time.time()
            train_loss, edges, overflow, timing = _train_epoch(
                step, it, cfg, epoch, gen, dev, step_args)
            valid = validate()
            best = ckpt.update(next(iter(valid.values())), state)
            save_checkpoint(latest_path, state)  # crash-restart point
            secs = time.time() - t0
            eps = edges * cfg.n_layers / max(secs, 1e-9)
            history.append(dict(epoch=epoch, loss=train_loss, **valid,
                                best=best, secs=secs, edges_per_s=eps,
                                edges=edges, edges_dropped=overflow,
                                **timing))
            if metrics is not None:
                metrics.log("epoch", **history[-1])
            _warn_overflow(log, overflow, edges)
            scores = " ".join(f"{_VALID_TEXT[k]} {v:.4f}"
                              for k, v in valid.items())
            log(f"epoch {epoch}: loss {train_loss:.4f} valid {scores}"
                f"{' *' if best else ''} ({secs:.1f}s, {eps/1e6:.2f}M "
                f"edges/s, {_timing_text(timing)})")
    return history


def _timing_text(timing) -> str:
    """The epoch log line's step-time and loader-wait part."""
    step = (f"step {timing['step_ms']:.1f} ms, "
            if timing["step_ms"] is not None else "")
    return f"{step}loader wait {timing['wait_ms']:.1f} ms/step"


def _loader(producer, cfg: ExperimentConfig, dev, loader_kw):
    return PrefetchLoader(_staged(producer), n_workers=cfg.n_pool,
                          repeat=cfg.repeat, seed=cfg.seed, device=dev,
                          **loader_kw)


def _as_dev(dev):
    return lambda a: torch.as_tensor(a, device=dev)


def _label_step_args(dev):
    """A labelled item's step arguments on ``dev`` (the node-classification
    and ogbn-mag losses)."""
    t = _as_dev(dev)

    def step_args(item):
        sub, tb = item.tb.sub, item.tb
        return (t(sub.node_feat), t(sub.node_mask), item.se, t(tb.labels),
                t(tb.label_mask))

    return step_args


def _test_metrics(eval_metrics, pairs, split, cfg: ExperimentConfig,
                  log) -> tuple:
    """NDCG and MRR averaged over 10 resampled test batches
    (``OAG/train_paper_field.py:295-327``)."""
    rng_t = np.random.default_rng(cfg.seed + 2)
    tests = [eval_metrics(pairs, split, rng_t) for _ in range(10)]
    test_ndcg = float(np.mean([t[0] for t in tests]))
    test_mrr = float(np.mean([t[1] for t in tests]))
    log(f"test NDCG {test_ndcg:.4f} MRR {test_mrr:.4f}")
    return test_ndcg, test_mrr


# ---------------------------------------------------------------------------
def run_node_classification(
    cfg: ExperimentConfig,
    graph: CSRGraph,
    label_meta,
    target_type: str = "paper",
    multi_label: bool = True,
    splits: Optional[Dict[str, TimeSplit]] = None,
    feature_fn: Optional[Callable] = None,
    log: Callable[[str], None] = print,
    resume: bool = False,
    device=None,
) -> Dict:
    """paper-field / paper-venue training + test (the reference's
    ``train_paper_field.py`` / ``train_paper_venue.py``) on ``device``
    (default ``cuda``; the CPU only when asked for). ``resume=True``
    continues from the per-epoch ``latest`` checkpoint.

    Per epoch the history records the JAX package's fields (``loss``,
    ``valid_ndcg``, ``valid_mrr``, ``best``, ``secs``, ``edges_per_s``,
    ``edges``, ``edges_dropped``) and the step timing of
    :func:`_train_epoch` (``step_ms``, ``step_ms_max``, ``wait_ms``)."""
    dev = resolve_device(device)
    splits = splits or OAG_SPLITS
    sampler = make_sampler(cfg, graph, log=log)
    task = NodeClassificationTask(
        graph=graph, sampler=sampler, layout=None,
        target_type=target_type, label_meta=label_meta,
        batch_size=cfg.batch_size, multi_label=multi_label,
        feature_fn=feature_fn,
    )
    # pairs keyed off the target-indexed reverse relation
    pairs = build_time_split_pairs(graph, task.rev_label_meta, splits)
    np.random.seed(cfg.seed)  # the reference's fixed subsample seed (:179)
    train_pairs = subsample_pairs(pairs["train"], cfg.data_percentage, cfg.seed)
    valid_pairs = subsample_pairs(pairs["valid"], cfg.data_percentage, cfg.seed)
    test_pairs = pairs["test"]
    _crng = np.random.default_rng(cfg.seed + 7)
    layout = make_layout(
        cfg, graph, sampler=sampler,
        seeds_fn=lambda: task.build_seeds(train_pairs, _crng)[0],
    )
    task.layout = layout
    log(f"layout: node cap {layout.node_cap}, {layout.num_edges} padded "
        f"edges in {len(layout.blocks)} blocks; {task.n_classes} classes")
    em = EdgeStaticMeta.from_layout(layout)
    em_dev = em.to(dev)
    model = node_classifier(
        cfg, layout, _probe_in_dim(task, train_pairs, splits),
        task.n_classes, target_type, head_mode="seeds").to(dev)
    log(f"model parameters: {get_n_params(model):,}")
    tx = make_tx(cfg, model.named_parameters(), cfg.n_batch * cfg.repeat)
    step, loader_kw, state, _ = make_exec(
        cfg, task.make_loss_fn(model, em_dev), tx, TrainState(model, tx))
    fwd = make_eval_step(model)

    def eval_metrics(pairs_, split_, rng):
        tb = task.sample(pairs_, split_, rng)
        se = sort_batch(tb.sub, layout, em, with_backward=False)
        logp = sorted_logprobs(fwd, tb.sub.node_feat, tb.sub.node_mask, se,
                               em_dev, dev)
        live = tb.label_mask
        if multi_label:
            rel = (np.asarray(tb.labels) > 0).astype(np.float64)
        else:
            rel = np.zeros((len(live), task.n_classes))
            rel[np.arange(len(live)), np.asarray(tb.labels)] = 1
        return ranking_metrics(logp[live], rel[live])

    state, start_epoch, ckpt, latest_path = _restore_latest(
        cfg, state, resume, log)
    producer = _producer_for(
        cfg, task.make_sample_fn(train_pairs, splits["train"]), layout, em)
    metrics = MetricsLogger(
        os.path.join(cfg.model_dir, f"{cfg.task_name}_metrics.jsonl")
    )
    rng_eval = np.random.default_rng(cfg.seed + 1)

    def validate():
        ndcg, mrr = eval_metrics(valid_pairs, splits["valid"], rng_eval)
        return dict(valid_ndcg=ndcg, valid_mrr=mrr)

    history = _fit(cfg, producer, step, _label_step_args(dev), loader_kw,
                   validate, state, start_epoch, ckpt, latest_path, dev, log,
                   metrics)

    test_ndcg, test_mrr = _test_metrics(eval_metrics, test_pairs,
                                        splits["test"], cfg, log)
    metrics.log("test", ndcg=test_ndcg, mrr=test_mrr)
    metrics.close()
    return dict(history=history, test_ndcg=test_ndcg, test_mrr=test_mrr,
                best_valid=ckpt.best, state=state)


# ---------------------------------------------------------------------------
def link_setup(
    cfg: ExperimentConfig,
    graph: CSRGraph,
    splits: Optional[Dict[str, TimeSplit]] = None,
    first_meta=("author", "paper", "rev_AP_write_first"),
    write_meta=("paper", "author", "AP_write_first"),
    max_group: int = 32,
    log: Callable[[str], None] = print,
):
    """The author-disambiguation task of ``cfg`` on its calibrated layout,
    and its model on the CPU, as :func:`run_author_disambiguation` and the
    serving ``LinkPredictor`` build them. Returns ``(task, pairs, model)``:
    ``task.layout`` is the layout, ``task.groups`` the name groups and
    ``pairs`` the split's (paper, author) pairs."""
    splits = splits or OAG_SPLITS
    sampler = make_sampler(cfg, graph, log=log)
    groups = build_name_groups(graph, first_meta)
    pairs = build_link_pairs(graph, groups, splits, first_meta)
    task = LinkPredictionTask(
        graph=graph, sampler=sampler, layout=None, groups=groups,
        write_meta=write_meta, batch_size=cfg.batch_size, max_group=max_group,
    )
    _crng = np.random.default_rng(cfg.seed + 7)
    task.layout = make_layout(
        cfg, graph, sampler=sampler,
        seeds_fn=lambda: task.build_seeds(
            pairs["train"], splits["train"], _crng
        )[0],
    )
    tb0 = task.sample(pairs["train"], splits["train"],
                      np.random.default_rng(cfg.seed))
    model = link_matcher(cfg, task.layout, _infer_in_dim(tb0),
                         task.paper_type)
    return task, pairs, model


# ---------------------------------------------------------------------------
def run_author_disambiguation(
    cfg: ExperimentConfig,
    graph: CSRGraph,
    splits: Optional[Dict[str, TimeSplit]] = None,
    first_meta=("author", "paper", "rev_AP_write_first"),
    write_meta=("paper", "author", "AP_write_first"),
    max_group: int = 32,
    log: Callable[[str], None] = print,
    resume: bool = False,
    device=None,
) -> Dict:
    """Author disambiguation by grouped link prediction (the reference's
    ``train_author_disambiguation.py``) on ``device`` (default ``cuda``).

    Per epoch the history records the JAX package's fields (``loss``,
    ``valid_ndcg``, ``valid_mrr``, ``best``, ``secs``, ``edges_dropped``)
    and the timing fields of :func:`run_node_classification` (``edges``,
    ``edges_per_s``, ``step_ms``, ``step_ms_max``, ``wait_ms``)."""
    dev = resolve_device(device)
    splits = splits or OAG_SPLITS
    task, pairs, model = link_setup(cfg, graph, splits, first_meta,
                                    write_meta, max_group, log)
    layout = task.layout
    log(f"layout: node cap {layout.node_cap}, {layout.num_edges} padded "
        f"edges in {len(layout.blocks)} blocks; {len(task.groups)} name "
        f"groups")
    em = EdgeStaticMeta.from_layout(layout)
    em_dev = em.to(dev)
    model = model.to(dev)
    log(f"model parameters: {get_n_params(model):,}")
    tx = make_tx(cfg, model.named_parameters(), cfg.n_batch * cfg.repeat)
    step, loader_kw, state, _ = make_exec(
        cfg, make_link_loss_fn(model, em_dev), tx, TrainState(model, tx))
    score_fn = make_eval_step(model)
    t = _as_dev(dev)

    def eval_metrics(pairs_, split_, rng):
        tb = task.sample(pairs_, split_, rng)
        se = sort_batch(tb.sub, layout, em, with_backward=False)
        scores = score_fn(t(tb.sub.node_feat), t(tb.sub.node_mask),
                          se.to(dev), em_dev, t(tb.cand_idx)).cpu().numpy()
        live = tb.query_mask
        rel = np.zeros_like(scores)
        rel[:, 0] = 1.0
        scores = np.where(tb.cand_mask, scores, -np.inf)
        return ranking_metrics(scores[live], rel[live])

    state, start_epoch, ckpt, latest_path = _restore_latest(
        cfg, state, resume, log)
    producer = _producer_for(
        cfg, task.make_sample_fn(pairs["train"], splits["train"]), layout, em)
    rng_eval = np.random.default_rng(cfg.seed + 1)

    def validate():
        ndcg, mrr = eval_metrics(pairs["valid"], splits["valid"], rng_eval)
        return dict(valid_ndcg=ndcg, valid_mrr=mrr)

    def step_args(item):
        sub, tb = item.tb.sub, item.tb
        return (t(sub.node_feat), t(sub.node_mask), item.se, t(tb.cand_idx),
                t(tb.cand_mask), t(tb.query_mask).float())

    history = _fit(cfg, producer, step, step_args, loader_kw, validate,
                   state, start_epoch, ckpt, latest_path, dev, log)

    test_ndcg, test_mrr = _test_metrics(eval_metrics, pairs["test"],
                                        splits["test"], cfg, log)
    return dict(history=history, test_ndcg=test_ndcg, test_mrr=test_mrr,
                best_valid=ckpt.best, state=state)


# ---------------------------------------------------------------------------
def run_ogbn(
    cfg: ExperimentConfig,
    graph: CSRGraph,
    log: Callable[[str], None] = print,
    eval_mode: str = "variance_reduce",
    max_eval_nodes: Optional[int] = None,
    resume: bool = False,
    device=None,
) -> Dict:
    """ogbn-mag training + VR/sequential eval (the reference's
    ``train_ogbn_mag.py`` and ``eval_ogbn_mag.py``), on ``device``
    (default ``cuda``; the CPU only when asked for).

    Per epoch the history records, beside the JAX package's fields
    (``loss``, ``valid_acc``, ``best``, ``secs``, ``edges_per_s``,
    ``edges``, ``edges_dropped``), the step timing of :func:`_train_epoch`
    (``step_ms``, ``step_ms_max``, ``wait_ms``).
    """
    dev = resolve_device(device)
    sampler = make_sampler(cfg, graph, log=log)
    _crng = np.random.default_rng(cfg.seed + 7)
    _years = np.asarray(graph.aux["years"]).reshape(-1)

    def _cal_seeds():
        pick = _crng.choice(len(_years), min(cfg.batch_size, len(_years)),
                            replace=False)
        return {"paper": np.stack([pick, _years[pick]], axis=1)}

    layout = make_layout(cfg, graph, sampler=sampler, seeds_fn=_cal_seeds)
    log(f"layout: node cap {layout.node_cap}, {layout.num_edges} padded "
        f"edges in {len(layout.blocks)} blocks")
    em = EdgeStaticMeta.from_layout(layout)
    em_dev = em.to(dev)
    task = OgbnNodeTask(
        graph=graph, sampler=sampler, layout=layout, batch_size=cfg.batch_size
    )
    rng0 = np.random.default_rng(cfg.seed)
    tb0 = task.sample(np.arange(min(cfg.batch_size, 4)), rng0)
    model = node_classifier(cfg, layout, _infer_in_dim(tb0), task.n_classes,
                            task.target_type).to(dev)
    log(f"model parameters: {get_n_params(model):,}")
    tx = make_tx(cfg, model.named_parameters(), cfg.n_batch * cfg.repeat)
    step, loader_kw, state, _ = make_exec(
        cfg, task.make_loss_fn(model, em_dev), tx, TrainState(model, tx))
    fwd = make_eval_step(model)

    state, start_epoch, ckpt, latest_path = _restore_latest(
        cfg, state, resume, log)
    metrics = MetricsLogger(
        os.path.join(cfg.model_dir, f"{cfg.task_name}_metrics.jsonl")
    )
    producer = _producer_for(cfg, task.make_sample_fn("train"), layout, em)
    rng_eval = np.random.default_rng(cfg.seed + 1)
    valid_nodes = np.where(task.masks["valid"])[0]

    def validate():
        # valid accuracy on a few sampled batches
        accs = []
        for _ in range(4):
            vtb = task.sample(
                rng_eval.choice(valid_nodes,
                                min(cfg.batch_size, len(valid_nodes)),
                                replace=False),
                rng_eval, split="valid",
            )
            vse = sort_batch(vtb.sub, layout, em, with_backward=False)
            logp = sorted_logprobs(fwd, vtb.sub.node_feat,
                                   vtb.sub.node_mask, vse, em_dev, dev)
            accs.append(task.accuracy(logp, np.asarray(vtb.labels),
                                      np.asarray(vtb.label_mask)))
        return dict(valid_acc=float(np.mean(accs)))

    history = _fit(cfg, producer, step, _label_step_args(dev), loader_kw,
                   validate, state, start_epoch, ckpt, latest_path, dev, log,
                   metrics)

    # final multi-sample eval (eval_ogbn_mag.py:128-179)
    def eval_forward(params, nf, es, et, dt, emk, nmk):
        se = sort_edges(es, et, dt, emk, layout, em, with_backward=False)
        return sorted_logprobs(make_eval_step(params), nf, nmk, se, em_dev,
                               dev)

    vr = multi_sample_eval(
        eval_forward, state.model, task, split="test",
        batch_size=cfg.batch_size,
        vr_num=cfg.vr_num if eval_mode == "variance_reduce" else 1,
        rng=np.random.default_rng(cfg.seed + 3),
        max_nodes=max_eval_nodes,
    )
    metrics.log("test", mode=eval_mode, **{k: v for k, v in vr.items()})
    metrics.close()
    log(f"test acc ({eval_mode}): {vr['acc']:.4f} "
        f"(sequential {vr['seq_acc']:.4f}, per-occurrence "
        f"{vr['single_sample_acc']:.4f}, n={vr['n_eval']})")
    return dict(history=history, test=vr, best_valid=ckpt.best, state=state)


# ---------------------------------------------------------------------------
def evaluate_ogbn(
    cfg: ExperimentConfig,
    graph: CSRGraph,
    ckpt_path: str,
    eval_mode: str = "variance_reduce",
    max_eval_nodes: Optional[int] = None,
    log: Callable[[str], None] = print,
    device=None,
) -> Dict:
    """Standalone checkpoint evaluation — the reference's separate
    ``eval_ogbn_mag.py`` entry point (``:107-191``): rebuild the model,
    restore the checkpoint, run VR or sequential eval, on ``device``
    (default ``cuda``). Built on the warm serving predictor
    (:mod:`pyhgt_tpu_torch.experiments.serving`), whose forward it
    shares."""
    from pyhgt_tpu_torch.experiments.serving import OgbnPredictor

    pred = OgbnPredictor(cfg, graph, ckpt_path, log=log, device=device)
    out = multi_sample_eval(
        pred.eval_forward, pred.params, pred.task, split="test",
        batch_size=cfg.batch_size,
        vr_num=cfg.vr_num if eval_mode == "variance_reduce" else 1,
        rng=np.random.default_rng(cfg.seed + 3),
        max_nodes=max_eval_nodes,
    )
    log(f"test acc ({eval_mode}): {out['acc']:.4f} "
        f"(sequential {out['seq_acc']:.4f}, per-occurrence "
        f"{out['single_sample_acc']:.4f}, n={out['n_eval']})")
    return out
