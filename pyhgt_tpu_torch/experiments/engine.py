"""Shared experiment engine: task assembly, epoch loop, evaluation.

Counterpart of the single-device path of
:mod:`pyhgt_tpu.experiments.engine`: ``make_sampler``, ``make_layout``,
``gnn_kwargs``, ``make_tx``, ``_infer_in_dim``, the producer-side train
item (``_Item``, ``_make_producer``), ``make_exec`` at dp = tp = gp = pp = 1,
``_warn_overflow``, the ogbn-mag runner :func:`run_ogbn` and the standalone
checkpoint evaluation :func:`evaluate_ogbn`; plus ``node_classifier`` (the
model the JAX package builds inline) and ``check_ported``. The OAG runners
(paper-field/venue, author disambiguation) are not ported yet.

Epoch-loop parity (``ogbn-mag/train_ogbn_mag.py:130-215``): per epoch,
``n_batch`` training batches (each trained on ``repeat`` times) plus a few
validation batches; valid accuracy gates best-model checkpointing; after
training, the test split is evaluated by the variance-reduced protocol
(``eval_ogbn_mag.py:128-179``). Sampling and the host sort overlap
training through :class:`~pyhgt_tpu_torch.train.loader.PrefetchLoader`.
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
from pyhgt_tpu_torch.models.composite import NodeClassifierModel
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.sampling.batch import BatchLayout
from pyhgt_tpu_torch.sampling.hgsampler import HGSampler
from pyhgt_tpu_torch.sampling.sorted_batch import (
    SortedEdges,
    sort_batch,
    sort_edges,
)
from pyhgt_tpu_torch.tasks.base import TaskBatch
from pyhgt_tpu_torch.tasks.evaluate import multi_sample_eval
from pyhgt_tpu_torch.tasks.ogbn import OgbnNodeTask
from pyhgt_tpu_torch.train.checkpoint import (
    BestCheckpointPolicy,
    load_checkpoint,
    save_checkpoint,
)
from pyhgt_tpu_torch.train.loader import PrefetchLoader
from pyhgt_tpu_torch.train.log import MetricsLogger
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


def node_classifier(cfg: ExperimentConfig, layout: BatchLayout, in_dim: int,
                    n_classes: int, target_type: str = "paper",
                    seed: Optional[int] = None):
    """The full-block ``NodeClassifierModel`` of ``cfg`` (the ogbn-mag
    head), on the CPU, with weights drawn from ``seed`` (default
    ``cfg.seed``)."""
    return NodeClassifierModel(
        gnn_kwargs(cfg, layout, in_dim), n_classes=n_classes,
        target_type_id=layout.schema.type_id(target_type), head_mode="full",
        generator=torch.Generator().manual_seed(
            cfg.seed if seed is None else seed),
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


# the name of run_ogbn's profiler span over an epoch's train steps
TRAIN_SPAN = "run_ogbn.train_steps"


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
    ``edges``, ``edges_dropped``), the step time ``step_ms`` (mean) and
    ``step_ms_max`` over the epoch's steps after its first — the interval
    between the ends of consecutive steps on the device's timeline, read
    once at the epoch's end — and ``wait_ms``, the consumer's mean wait on
    the loader per step (host clock). The losses stay on the device until
    the epoch ends.
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
    state = TrainState(model, tx)
    step, loader_kw, state, _ = make_exec(
        cfg, task.make_loss_fn(model, em_dev), tx, state)
    fwd = make_eval_step(model)

    ckpt = BestCheckpointPolicy(
        os.path.join(cfg.model_dir, f"{cfg.task_name}_{cfg.conv_name}")
    )
    latest_path = os.path.join(
        cfg.model_dir, f"{cfg.task_name}_{cfg.conv_name}_latest"
    )
    start_epoch = 0
    if resume and os.path.exists(latest_path):
        state = load_checkpoint(latest_path, state)
        start_epoch = int(state.step) // (cfg.n_batch * cfg.repeat)
        log(f"resumed from {latest_path} at epoch {start_epoch}")
    history = []
    metrics = MetricsLogger(
        os.path.join(cfg.model_dir, f"{cfg.task_name}_metrics.jsonl")
    )
    producer = _make_producer(
        task.make_sample_fn("train"), layout, em,
        tgt_rank_cap=cfg.tgt_rank_cap, src_rank_cap=cfg.src_rank_cap,
        tab_cap=cfg.tab_cap, src_split_cap=cfg.src_split_cap)
    # the step's dropout masks: one stream per step, seeded as the JAX
    # package keys its step (epoch * 10000 + b)
    gen = torch.Generator(device=dev)

    def as_dev(a):
        return torch.as_tensor(a, device=dev)

    with PrefetchLoader(
        _staged(producer), n_workers=cfg.n_pool, repeat=cfg.repeat,
        seed=cfg.seed, device=dev, **loader_kw,
    ) as loader:
        it = iter(loader)
        rng_eval = np.random.default_rng(cfg.seed + 1)
        valid_nodes = np.where(task.masks["valid"])[0]
        for epoch in range(start_epoch, cfg.n_epoch):
            t0 = time.time()
            losses, marks = [], []
            edges = overflow = 0
            wait = 0.0
            # a profiler span over the epoch's steps, up to the read of
            # their losses (a trace's idle share is read within it)
            with torch.profiler.record_function(TRAIN_SPAN):
                for b in range(cfg.n_batch * cfg.repeat):
                    tw = time.perf_counter()
                    item = next(it)
                    wait += time.perf_counter() - tw
                    edges += item.n_edges
                    overflow += item.overflow
                    sub, tb = item.tb.sub, item.tb
                    gen.manual_seed(epoch * 10000 + b)
                    loss = step(gen, as_dev(sub.node_feat),
                                as_dev(sub.node_mask), item.se,
                                as_dev(tb.labels), as_dev(tb.label_mask))
                    losses.append(loss)
                    marks.append(_step_mark(dev))
                # the one read of the epoch's losses (it waits for the
                # device)
                train_loss = float(np.mean(
                    torch.stack(losses).cpu().numpy().astype(np.float64)))
            step_ms = [_ms_between(a, b) for a, b in zip(marks, marks[1:])]
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
            vacc = float(np.mean(accs))
            best = ckpt.update(vacc, state)
            save_checkpoint(latest_path, state)  # crash-restart point
            secs = time.time() - t0
            eps = edges * cfg.n_layers / max(secs, 1e-9)
            history.append(dict(
                epoch=epoch, loss=train_loss, valid_acc=vacc, best=best,
                secs=secs, edges_per_s=eps, edges=edges,
                edges_dropped=overflow,
                step_ms=float(np.mean(step_ms)) if step_ms else None,
                step_ms_max=float(np.max(step_ms)) if step_ms else None,
                wait_ms=wait * 1e3 / (cfg.n_batch * cfg.repeat)))
            metrics.log("epoch", **history[-1])
            _warn_overflow(log, overflow, edges)
            timing = (f"step {history[-1]['step_ms']:.1f} ms, " if step_ms
                      else "")
            log(f"epoch {epoch}: loss {train_loss:.4f} valid acc {vacc:.4f}"
                f"{' *' if best else ''} ({secs:.1f}s, {eps/1e6:.2f}M "
                f"edges/s, {timing}loader wait "
                f"{history[-1]['wait_ms']:.1f} ms/step)")

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
