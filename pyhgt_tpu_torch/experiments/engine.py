"""Shared experiment engine: task assembly, epoch loop, evaluation.

Counterpart of :mod:`pyhgt_tpu.experiments.engine`: ``make_sampler``,
``make_layout``, ``gnn_kwargs``, ``make_tx``, ``_infer_in_dim``, the
producer-side train item (``_Item``, ``_make_producer`` with its graph-axis
partition, ``_stack_items``), ``make_exec`` with its data-parallel,
edge-partitioned, tensor-parallel and pipelined branches (``_exec_parts``,
``_make_pp_exec``), ``_warn_overflow``, the OAG split ``OAG_SPLITS``, ``_probe_in_dim``, the
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
:class:`~pyhgt_tpu_torch.train.loader.PrefetchLoader`.

Under ``dp``, ``tp``, ``gp`` or ``pp`` above 1 each rank is one process
of a ``torch.distributed`` world (``python -m pyhgt_tpu_torch.run`` under
``torchrun``): every rank of a model, graph or pipe group trains on the
same items, which the group's first rank samples and sends; data ranks
sample their own. The layout is rank 0's, sent to every rank (calibration
draws from an unseeded generator). Only rank 0 evaluates (the
single-device forward of the runner's whole model, into which the spread
parameters are gathered first), writes checkpoints (the whole model and
optimizer, which a single process loads) and the metrics jsonl, and logs;
the other ranks receive its scores. A resume restores the whole state and
hands each rank its part. One epoch loop
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
from pyhgt_tpu_torch.graph.schema import PadSpec, sampler_node_bound
from pyhgt_tpu_torch.models.composite import (
    LinkMatcherModel,
    NodeClassifierModel,
)
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.parallel.distributed import world
from pyhgt_tpu_torch.parallel.edge_partition import (
    EdgeShard,
    partition_sorted,
)
from pyhgt_tpu_torch.parallel import mesh as pmesh
from pyhgt_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    GRAPH_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    make_mesh,
)
from pyhgt_tpu_torch.parallel import pipeline as ppl
from pyhgt_tpu_torch.parallel.spmd import (
    make_dp_train_step,
    make_gp_train_step,
    make_tp_train_step,
)
from pyhgt_tpu_torch.sampling.batch import BatchLayout, pad_counts
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
    load_named_optimizer_state,
    named_optimizer_state,
    save_checkpoint,
)
from pyhgt_tpu_torch.train.graph_step import GraphedStep
from pyhgt_tpu_torch.train.loader import PrefetchLoader
from pyhgt_tpu_torch.train.log import MetricsLogger
from pyhgt_tpu_torch.train.metrics import ranking_metrics
from pyhgt_tpu_torch.train.optim import (
    cosine_schedule,
    cosine_torch_schedule,
    make_optimizer,
    onecycle_schedule,
    with_bf16_params,
)
from pyhgt_tpu_torch.train.step import TrainState, make_eval_step
from pyhgt_tpu_torch.utils.experiment import get_n_params

# the reference's temporal split: train<2015 / 2015<=valid<=2016 / test>2016
# (OAG/train_paper_field.py:74-76)
OAG_SPLITS = {
    "train": TimeSplit(hi=2014),
    "valid": TimeSplit(lo=2015, hi=2016),
    "test": TimeSplit(lo=2017),
}


def check_ported(cfg: ExperimentConfig) -> None:
    """Raise on a configuration the port cannot run: the JAX package's
    refusals of tp with gp or pp (``ValueError``, its reasons). Every
    other knob runs (``param_bf16``, ``remat`` and ``fused_opt`` in every
    mode)."""
    if cfg.tp > 1 and cfg.gp > 1:
        # the JAX package's design decision (pyhgt_tpu/experiments/engine.py)
        raise ValueError(
            "gp>1 does not compose with tp>1 by design: tp shards "
            "parameter memory (~1.5% of HBM at reference scale) while gp "
            "shards the per-edge tensors that actually bind; use dp x gp "
            "(or dp x tp without gp)")
    if cfg.tp > 1 and cfg.pp > 1:
        raise ValueError("pp composes with dp only (pp x tp / pp x gp are "
                         "not wired)")


def shared_layout(make: Callable[[], BatchLayout]) -> BatchLayout:
    """``make()`` on rank 0, sent to every rank of a parallel run (the
    layout's calibration draws from an unseeded generator, and every rank
    of a group must pad to the same shapes); ``make()`` alone on one
    process."""
    rank, n = world()
    if n == 1:
        return make()
    import torch.distributed as dist

    box = [make() if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


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
    seeds_bounded: bool = True,
) -> BatchLayout:
    """The padded layout of ``cfg``'s batches: calibrated from ``sampler``'s
    draws of ``seeds_fn()`` seeds when ``cfg.calibrate_caps``, else
    HGSampling's bound (``PadSpec.for_sampler``, with ``cfg.edge_cap``);
    ``cfg.node_cap``, when set, wins. ``seeds_bounded``: the task seeds at
    most ``cfg.batch_size`` nodes of any one type (the node-classification
    tasks), so HGSampling's bound caps the calibrated node cap; the link
    task's author seeds (whole name groups) have no such bound."""
    if cfg.calibrate_caps and sampler is not None and seeds_fn is not None:
        # size per-meta edge caps from measured draws (PadSpec.calibrate);
        # overflow beyond the cap is subsampled by pad_sample anyway
        bound = (sampler_node_bound(cfg.batch_size, cfg.sample_depth,
                                    cfg.sample_width)
                 if seeds_bounded else None)
        pad = PadSpec.calibrate(sampler, seeds_fn, node_bound=bound)
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
    """:class:`~pyhgt_tpu_torch.models.model.GNN`'s arguments: any conv of
    the JAX package (``conv_name``) on either edge path (``edge_impl``),
    edge-partitioned under ``gp > 1`` (``graph_axis``, ``gp_overlap``),
    each HGT conv's edge core recomputed in the backward under ``remat``;
    an unknown conv name raises when the model is built. Tensor
    parallelism is not a model argument: :func:`make_exec` shards a built
    model (:func:`~pyhgt_tpu_torch.parallel.mesh.shard_model`)."""
    return dict(
        in_dim=in_dim,
        n_hid=cfg.n_hid,
        num_types=layout.num_types,
        num_relations=layout.schema.num_relations,
        n_heads=cfg.n_heads,
        n_layers=cfg.n_layers,
        dropout=cfg.dropout,
        conv_name=cfg.conv_name,
        prev_norm=cfg.prev_norm,
        last_norm=cfg.last_norm,
        use_rte=cfg.use_rte,
        edge_impl=cfg.edge_impl,
        save_kv=cfg.save_kv,
        edge_bf16=cfg.edge_bf16,
        edge_bwd=cfg.edge_bwd,
        seg_pallas=cfg.seg_pallas,
        softmax_pallas=cfg.softmax_pallas,
        softmax_tilemax=cfg.softmax_tilemax,
        graph_axis=GRAPH_AXIS if cfg.gp > 1 else "",
        gp_overlap=cfg.gp_overlap,
        remat=cfg.remat,
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
    configured schedule, weight decay and clip, the flattened-vector AdamW
    under ``fused_opt``."""
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
                          clip_norm=cfg.clip, name=cfg.optimizer,
                          fused=cfg.fused_opt)


def _infer_in_dim(task_batch) -> int:
    return int(task_batch.sub.node_feat.shape[-1])


def _probe_in_dim(task, pairs, splits) -> int:
    tb = task.sample(pairs, splits["train"], np.random.default_rng(0))
    return _infer_in_dim(tb)


def raw_edges(model, sub, device):
    """The raw edge arrays ``(edge_src, edge_tgt, edge_dt, edge_mask)`` of
    the batch ``sub`` (a ``SubgraphBatch`` or those four arrays, host
    arrays or tensors) as tensors on ``device`` when ``model``'s GNN reads
    them (the segment path, the baseline convs), else None: the sorted HGT
    path reads the sorted layout alone and copies nothing more."""
    if not model.gnn.reads_edges:
        return None
    if hasattr(sub, "edge_src"):
        sub = (sub.edge_src, sub.edge_tgt, sub.edge_dt, sub.edge_mask)
    return tuple(torch.as_tensor(a, device=device) for a in sub)


def sorted_logprobs(forward, node_feat, node_mask, se: SortedEdges, em_dev,
                    device, edges=None) -> np.ndarray:
    """Host log-probs of one batch through ``forward`` (a
    :func:`~pyhgt_tpu_torch.train.step.make_eval_step` of the model): the
    node features and mask and ``se`` to ``device``, the forward (with
    ``edges``, the raw edge arrays of :func:`raw_edges`, for a model that
    reads them), the result back on the host."""
    return forward(
        torch.as_tensor(node_feat, device=device),
        torch.as_tensor(node_mask, device=device),
        se.to(device), em_dev, edges=edges,
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


def _make_producer(sample_fn, layout, em, gp: int = 1,
                   tgt_rank_cap: int = 0, src_rank_cap: int = 0,
                   tab_cap: int = 0, src_split_cap: int = 0):
    """``fn(rng) -> _Item``: ``sample_fn(rng)``, then the host sort with
    the backward's aux and the configured caps. ``gp > 1``: the item
    carries the batch's :class:`PartitionedEdges` (``gp`` contiguous edge
    shards, built on the producer threads) instead of its SortedEdges; the
    sort then skips the caps, which the partition applies per shard, and
    the two-region src aux, which a shard does not take."""
    gp_tab_cap = gp_rank_cap = 0
    if gp > 1:
        gp_tab_cap, tab_cap = tab_cap, 0
        gp_rank_cap, tgt_rank_cap = tgt_rank_cap, 0
        src_split_cap = 0

    def fn(rng):
        tb = sample_fn(rng)
        se = sort_batch(tb.sub, layout, em, tgt_rank_cap=tgt_rank_cap,
                        src_rank_cap=src_rank_cap, tab_cap=tab_cap,
                        src_split_cap=src_split_cap)
        if gp > 1:
            se = partition_sorted(
                se, gp, num_blocks=len(layout.blocks),
                node_cap=layout.node_cap,
                num_nodes_flat=layout.num_types * layout.node_cap,
                tgt_rank_cap=gp_rank_cap, tab_cap=gp_tab_cap)
        return _Item(
            tb, se,
            int(np.asarray(tb.sub.edge_mask).sum()),
            int(np.asarray(tb.sub.block_overflow).sum()),
        )

    return fn


def _producer_for(cfg: ExperimentConfig, sample_fn, layout, em):
    """:func:`_make_producer` with ``cfg``'s aux caps."""
    return _make_producer(sample_fn, layout, em, gp=cfg.gp,
                          tgt_rank_cap=cfg.tgt_rank_cap,
                          src_rank_cap=cfg.src_rank_cap, tab_cap=cfg.tab_cap,
                          src_split_cap=cfg.src_split_cap)


def _staged(producer):
    """``producer`` whose item's SortedEdges (or each shard's) are already
    in the form the step reads (:meth:`SortedEdges.to` on the CPU: int32
    indices, each kernel aux checked), still on the worker thread; the
    loader moves it to the device."""
    cpu = torch.device("cpu")

    def fn(rng):
        item = producer(rng)
        return dataclasses.replace(item, se=item.se.to(cpu))

    return fn


def _stack_items(items):
    """Collate producer items into one (the pipeline's microbatches): the
    task batches and sorted edges as tuples, the host counts summed."""
    return _Item(tuple(it.tb for it in items), tuple(it.se for it in items),
                 sum(it.n_edges for it in items),
                 sum(it.overflow for it in items))


def _unstack_item(item):
    return [_Item(tb, se, 0, 0) for tb, se in zip(item.tb, item.se)]


def _exec_parts(cfg: ExperimentConfig, em, head_loss, loss_for,
                steps_per_epoch: int):
    """The task side of :func:`make_exec`'s tp and pp branches: the task
    head's loss of one microbatch, ``head_loss(model, h_out, *labels)``
    (pp), the task's loss of another model, ``loss_for(model)`` (tp: the
    sharded copy), the ``EdgeStaticMeta`` on the device, the layer count
    and a rebuilder of the optimizer over a part of the parameters."""
    return dict(head_loss=head_loss, loss_for=loss_for, em=em,
                n_layers=cfg.n_layers,
                remake_tx=lambda named: make_tx(cfg, named, steps_per_epoch))


def _make_pp_exec(cfg: ExperimentConfig, pp_parts, state, dp: int, pp: int):
    """The pp branch of :func:`make_exec`: GPipe over the ranks of a
    ``pipe`` axis (times ``data``), the task head from ``pp_parts``; the
    optimizer is rebuilt over this stage's parameters. The step takes
    ``(generator, micro)``."""
    ppl.check_pipeline(cfg.n_layers, pp, cfg.prev_norm, cfg.last_norm, dp=dp,
                       tp=cfg.tp, gp=cfg.gp)
    n_micro = max(cfg.pp_micro, 0) or 2 * pp
    mesh = ppl.make_pipe_mesh(pp, n_data=dp)
    loss = ppl.make_pp_task_loss(state.model, pp_parts["head_loss"], mesh,
                                 n_micro, pp_parts["em"],
                                 param_bf16=cfg.param_bf16)
    tx = pp_parts["remake_tx"](loss.stage.named_parameters())
    state = TrainState(state.model, tx)
    step = ppl.make_pp_train_step(loss, tx, mesh)
    loader_kw = dict(stack=n_micro, collate=_stack_items,
                     group=mesh.group(PIPE_AXIS),
                     src=mesh.members(PIPE_AXIS)[0],
                     seed=cfg.seed + mesh.index(DATA_AXIS))
    return step, loader_kw, state, mesh


def _make_tp_exec(cfg: ExperimentConfig, parts, state, dp: int, tp: int):
    """The tp branch of :func:`make_exec`: a ``(data, model)`` mesh, this
    rank's sharded copy of the model
    (:func:`~pyhgt_tpu_torch.parallel.mesh.shard_model`) with the task's
    loss and an optimizer over it, and every model rank of a data row fed
    the same items (the row's first rank samples and sends them)."""
    mesh = make_mesh(n_data=dp, n_model=tp)
    model = pmesh.shard_model(state.model, mesh)
    named = list(model.named_parameters())
    tx = parts["remake_tx"](named)
    loss = parts["loss_for"](model)
    if cfg.param_bf16:
        loss = with_bf16_params(loss, model)
    step = make_tp_train_step(loss, tx, named, mesh)
    loader_kw = dict(seed=cfg.seed + mesh.index(DATA_AXIS),
                     group=mesh.group(MODEL_AXIS),
                     src=mesh.members(MODEL_AXIS)[0])
    return step, loader_kw, TrainState(model, tx), mesh


def _capturable(cfg: ExperimentConfig) -> bool:
    """Whether ``cfg``'s one-device step may be captured in CUDA graphs
    (:class:`~pyhgt_tpu_torch.train.graph_step.GraphedStep`, which also
    keeps ``fused_opt``'s flat AdamW eager: its step count lives on the
    host). ``softmax_tilemax="auto"`` reads its guard from the device on
    the host; ``param_bf16`` and ``remat`` stay eager too, their
    ``functional_call`` and recompute not having been captured."""
    return not (cfg.param_bf16 or cfg.remat
                or cfg.softmax_tilemax == "auto")


def make_exec(cfg: ExperimentConfig, loss_fn, tx, state, parts=None):
    """The train step for ``cfg``, honoring ``dp`` / ``tp`` / ``gp`` /
    ``pp`` over the ranks of the ``torch.distributed`` world (one process
    per rank):

    - one device: :class:`~pyhgt_tpu_torch.train.graph_step.GraphedStep`,
      :func:`~pyhgt_tpu_torch.train.step.make_train_step`'s step replayed
      from CUDA graphs where it can be (:func:`_capturable`; eager on the
      CPU);
    - dp > 1: each data rank runs the unbatched loss on its own item; the
      loss and gradients are averaged over the data group before the clip
      and the update (:func:`~pyhgt_tpu_torch.parallel.spmd.make_dp_train_step`);
    - tp > 1: Megatron-style tensor parallelism over the model group, the
      JAX package's head-sharded parameter banks
      (:func:`~pyhgt_tpu_torch.parallel.mesh.param_shardings`); each model
      rank trains its slices of a sharded copy of ``state.model`` on the
      same items; composes with dp, not with gp or pp
      (:func:`check_ported`);
    - gp > 1: each batch's edges split over the graph group, every rank
      training on its shard (:mod:`pyhgt_tpu_torch.parallel.edge_partition`);
      composes with dp;
    - pp > 1: the conv stack staged over a pipe group, ``cfg.pp_micro``
      (default 2 * pp) microbatches per step on the GPipe schedule
      (:mod:`pyhgt_tpu_torch.parallel.pipeline`); composes with dp.

    ``param_bf16`` runs the loss in every mode on the bf16 casts of the
    weight banks, f32 masters in the optimizer
    (:func:`~pyhgt_tpu_torch.train.optim.with_bf16_params`; under tp over
    the sharded copy, under pp over each stage's parameters), as the JAX
    package wraps its loss before the mode branches.

    ``parts`` (:func:`_exec_parts`, from the runner) carries what the tp
    and pp branches rebuild. Returns ``(step, loader_kwargs, state, mesh)``
    as the JAX package does: the loader's feed of this rank, the state
    (under tp the sharded copy and its optimizer, under pp the optimizer
    over this stage's parameters), and the
    :class:`~pyhgt_tpu_torch.parallel.mesh.Mesh` (None on one device)."""
    check_ported(cfg)
    if cfg.param_bf16:
        loss_fn = with_bf16_params(loss_fn, state.model)
    dp, tp = max(cfg.dp, 1), max(cfg.tp, 1)
    gp, pp = max(cfg.gp, 1), max(cfg.pp, 1)
    if dp == tp == gp == pp == 1:
        step = GraphedStep(loss_fn, tx, state.model,
                           capture=_capturable(cfg))
        return step, {}, state, None
    if (pp > 1 or tp > 1) and parts is None:
        raise ValueError("tp or pp > 1 needs the task's parts "
                         "(_exec_parts: this runner does not support them)")
    if pp > 1:
        if gp > 1:
            raise ValueError("pp composes with dp only (pp x gp is not "
                             "wired)")
        return _make_pp_exec(cfg, parts, state, dp=dp, pp=pp)
    if tp > 1:
        return _make_tp_exec(cfg, parts, state, dp=dp, tp=tp)
    mesh = make_mesh(n_data=dp, n_model=1, n_graph=gp)
    loader_kw = dict(seed=cfg.seed + mesh.index(DATA_AXIS))
    if gp > 1:
        step = make_gp_train_step(loss_fn, tx, mesh)
        group = mesh.group(GRAPH_AXIS)
        loader_kw.update(
            group=group, src=mesh.members(GRAPH_AXIS)[0],
            split=lambda item: [dataclasses.replace(item, se=sh)
                                for sh in item.se.shards],
            local=lambda item: dataclasses.replace(
                item, se=EdgeShard(item.se, group)))
    else:
        step = make_dp_train_step(loss_fn, tx, mesh)
    return step, loader_kw, state, mesh


def export_state(state: TrainState, full: TrainState, mesh) -> None:
    """Collect a parallel run's ``state`` into ``full`` (the runner's whole
    model and its optimizer over every parameter) on rank 0, for its
    evaluation and checkpoints: under tp the sharded model's parameters
    and optimizer moments joined along each parameter's split axis, under
    pp the stages' layers and their optimizer state; the step count.
    Every rank calls it; off those modes ``state`` is ``full``."""
    if state is full or mesh is None:
        return
    if PIPE_AXIS in mesh.axes:
        stage = ppl.Stage(state.model, mesh)
        ppl.gather_pipeline_params(state.model, mesh)
        moments = ppl.gather_pipeline_optimizer_state(state.optimizer, stage,
                                                      mesh)
        params = None
    else:
        params = pmesh.gather_params(state.model, mesh)
        named = list(state.model.named_parameters())
        moments = _per_moment(named_optimizer_state(state.optimizer, named),
                              pmesh.param_shardings(named),
                              lambda t, ax: pmesh.join_along(t, ax, mesh))
    if world()[0] != 0:
        return
    if params is not None:
        full.model.load_state_dict(params, strict=True)
    load_named_optimizer_state(full.optimizer,
                               list(full.model.named_parameters()), moments)
    full.optimizer.count = state.step


def restore_state(full: TrainState, state: TrainState, mesh) -> None:
    """The inverse of :func:`export_state` on every rank: ``full`` holds a
    whole restored checkpoint, and this rank's ``state`` takes its part:
    under tp its slices of each parameter and moment, under pp its
    stage's optimizer state (every rank holds the whole model there); the
    step count."""
    if state is full:
        return
    by_name = named_optimizer_state(full.optimizer,
                                    list(full.model.named_parameters()))
    if PIPE_AXIS in mesh.axes:
        named = ppl.Stage(state.model, mesh).named_parameters()
    else:
        named = list(state.model.named_parameters())
        state.model.load_state_dict(
            pmesh.shard_params(full.model.state_dict(), mesh), strict=True)
        by_name = _per_moment(by_name, pmesh.param_shardings(named),
                              lambda t, ax: pmesh.split_along(t, ax, mesh))
    load_named_optimizer_state(state.optimizer, named, by_name)
    state.optimizer.count = full.optimizer.count


def _per_moment(by_name, axes, fn):
    """``by_name`` (per-parameter optimizer state) with ``fn(tensor, axis)``
    applied to each moment, a tensor of its parameter's shape split on the
    parameter's ``axes[name]``; a 0-d ``step`` is kept."""
    return {n: {k: (fn(v, axes[n]) if torch.is_tensor(v) and v.dim() else v)
                for k, v in st.items()}
            for n, st in by_name.items()}


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


def _restore_latest(cfg: ExperimentConfig, state: TrainState,
                    full: TrainState, mesh, resume: bool, log):
    """The best-valid policy and the ``latest`` path of ``cfg``'s run, and,
    under ``resume``, the whole state restored from ``latest`` when it
    exists: into ``full`` (the runner's model and optimizer), then this
    rank's part of it into ``state`` (:func:`restore_state`). Returns
    ``(start_epoch, policy, latest_path)``."""
    prefix = os.path.join(cfg.model_dir, f"{cfg.task_name}_{cfg.conv_name}")
    latest_path = f"{prefix}_latest"
    start_epoch = 0
    if resume and os.path.exists(latest_path):
        load_checkpoint(latest_path, full)
        restore_state(full, state, mesh)
        start_epoch = int(state.step) // (cfg.n_batch * cfg.repeat)
        log(f"resumed from {latest_path} at epoch {start_epoch}")
    return start_epoch, BestCheckpointPolicy(prefix), latest_path


def _train_epoch(step, it, cfg: ExperimentConfig, epoch: int, gen, dev,
                 step_args, fold=(1, 0)):
    """One epoch's ``n_batch * repeat`` steps on the loader's items:
    ``step(gen, *step_args(item))`` with ``gen`` reseeded per step as the
    JAX package keys its step (``epoch * 10000 + b``), the data rank folded
    in (``fold = (dp, data index)``: data ranks draw other dropout masks,
    the ranks of a graph or pipe group the same). The losses stay on the
    device until the epoch's steps are queued, then are read once.

    Returns ``(train_loss, edges, overflow, timing)``; ``timing`` holds
    ``step_ms`` (mean) and ``step_ms_max`` over the steps after the first
    (the interval between the ends of consecutive steps on the device's
    timeline), ``wait_ms``, the consumer's mean wait on the loader per
    step (host clock), and ``graph_share``, the share of the steps a CUDA
    graph replayed (:class:`~pyhgt_tpu_torch.train.graph_step.GraphedStep`;
    0 for a step that has no graphs)."""
    n_steps = cfg.n_batch * cfg.repeat
    losses, marks = [], []
    edges = overflow = 0
    wait = 0.0
    replays = getattr(step, "replays", 0)
    # a profiler span over the epoch's steps, up to the read of their
    # losses (a trace's idle share is read within it)
    with torch.profiler.record_function(TRAIN_SPAN):
        for b in range(n_steps):
            tw = time.perf_counter()
            item = next(it)
            wait += time.perf_counter() - tw
            edges += item.n_edges
            overflow += item.overflow
            gen.manual_seed((epoch * 10000 + b) * fold[0] + fold[1])
            losses.append(step(gen, *step_args(item)))
            marks.append(_step_mark(dev))
        # the one read of the epoch's losses (it waits for the device)
        train_loss = float(np.mean(
            torch.stack(losses).cpu().numpy().astype(np.float64)))
    step_ms = [_ms_between(a, b) for a, b in zip(marks, marks[1:])]
    timing = dict(
        step_ms=float(np.mean(step_ms)) if step_ms else None,
        step_ms_max=float(np.max(step_ms)) if step_ms else None,
        wait_ms=wait * 1e3 / n_steps,
        graph_share=(getattr(step, "replays", 0) - replays) / n_steps)
    return train_loss, edges, overflow, timing


# the epoch log line's name of each validation field
_VALID_TEXT = {"valid_ndcg": "NDCG", "valid_mrr": "MRR", "valid_acc": "acc"}


def _from_lead(obj, mesh):
    """``obj`` of rank 0 on every rank (a no-op on one device)."""
    if mesh is None:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _lead_log(log):
    """``log`` on rank 0, silence on the others."""
    return log if world()[0] == 0 else (lambda s: None)


def _pp_step_args(step_args, mesh):
    """A pipeline's step arguments: the microbatches of a stacked item,
    each ``(node_feat, node_mask, se, edges, *labels)`` from the runner's
    ``step_args`` (the raw edges last there); unchanged off a pipeline."""
    if mesh is None or PIPE_AXIS not in mesh.axes:
        return step_args

    def args(item):
        micro = []
        for sub in _unstack_item(item):
            a = step_args(sub)
            micro.append((a[0], a[1], a[2], a[-1], *a[3:-1]))
        return (micro,)

    return args


def _fit(cfg: ExperimentConfig, producer, step, step_args, loader_kw,
         validate, state, full, start_epoch: int, ckpt, latest_path: str,
         dev, log, metrics=None, mesh=None) -> list:
    """The runners' epoch loop, from ``start_epoch`` to ``cfg.n_epoch``:
    :func:`_train_epoch` on a :class:`PrefetchLoader` over ``producer``,
    then ``validate()`` (the epoch's validation fields, a dict whose first
    value gates the best checkpoint), the best and ``latest`` checkpoints,
    the history record (also to ``metrics`` when given), the overflow
    warning and the epoch's log line. Returns the history.

    On a ``mesh`` (the parallel modes), the spread state is gathered into
    ``full`` on rank 0 (:func:`export_state`), which alone validates (the
    runner's ``validate`` reads ``full.model``) and writes the whole
    checkpoints; every rank gets its scores. The dropout generator folds
    in the data index only, so the ranks of a model, graph or pipe group
    draw the same masks."""
    history = []
    gen = torch.Generator(device=dev)
    lead = world()[0] == 0
    fold = ((mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)) if mesh is not None
            else (1, 0))
    step_args = _pp_step_args(step_args, mesh)
    with _loader(producer, cfg, dev, loader_kw) as loader:
        it = iter(loader)
        for epoch in range(start_epoch, cfg.n_epoch):
            t0 = time.time()
            train_loss, edges, overflow, timing = _train_epoch(
                step, it, cfg, epoch, gen, dev, step_args, fold)
            export_state(state, full, mesh)
            valid = best = None
            if lead:
                valid = validate()
                best = ckpt.update(next(iter(valid.values())), full)
                save_checkpoint(latest_path, full)  # crash-restart point
            valid, best = _from_lead((valid, best), mesh)
            if best and not lead:   # the same best score on every rank
                ckpt.best = float(next(iter(valid.values())))
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


def _node_cap_text(layout: BatchLayout) -> str:
    """The ``layout:`` line's node cap, with what sized a calibrated one:
    HGSampling's bound and the cap the calibration draws asked for."""
    pad = layout.pad
    if pad.node_calibrated is None:
        return f"node cap {pad.node_cap}"
    bound = "none" if pad.node_bound is None else pad.node_bound
    return (f"node cap {pad.node_cap} (sampler bound {bound}, calibrated "
            f"{pad.node_calibrated})")


def _truncated_text(since) -> str:
    """The run's closing ``layout:`` line: the node rows ``pad_sample``
    truncated since ``since`` (a ``pad_counts.read()``), on this process."""
    batches, rows, cut = (a - b for a, b in zip(pad_counts.read(), since))
    return (f"layout: {cut} node rows truncated in {batches} padded batches "
            f"({rows} rows filled)")


def _metrics_logger(cfg: ExperimentConfig) -> MetricsLogger:
    """The run's metrics jsonl; on a rank other than 0 a sink that writes
    nothing."""
    path = os.path.join(cfg.model_dir, f"{cfg.task_name}_metrics.jsonl")
    return MetricsLogger(path if world()[0] == 0 else None)


def _timing_text(timing) -> str:
    """The epoch log line's step-time, loader-wait and graph-share part."""
    step = (f"step {timing['step_ms']:.1f} ms, "
            if timing["step_ms"] is not None else "")
    return (f"{step}loader wait {timing['wait_ms']:.1f} ms/step, graph "
            f"share {timing['graph_share']:.2f}")


def _loader(producer, cfg: ExperimentConfig, dev, loader_kw):
    return PrefetchLoader(_staged(producer), n_workers=cfg.n_pool,
                          repeat=cfg.repeat, device=dev,
                          **{"seed": cfg.seed, **loader_kw})


def _as_dev(dev):
    return lambda a: torch.as_tensor(a, device=dev)


def _label_step_args(dev, model):
    """A labelled item's step arguments on ``dev`` (the node-classification
    and ogbn-mag losses), the raw edges last for a model that reads them
    (the loader has copied the item, so they cost no copy)."""
    t = _as_dev(dev)

    def step_args(item):
        sub, tb = item.tb.sub, item.tb
        return (t(sub.node_feat), t(sub.node_mask), item.se, t(tb.labels),
                t(tb.label_mask), raw_edges(model, sub, dev))

    return step_args


def _test_metrics(eval_metrics, pairs, split, cfg: ExperimentConfig,
                  log, mesh=None) -> tuple:
    """NDCG and MRR averaged over 10 resampled test batches
    (``OAG/train_paper_field.py:295-327``), on rank 0 and sent to the
    others on a ``mesh``."""
    if world()[0] != 0:
        return _from_lead(None, mesh)
    rng_t = np.random.default_rng(cfg.seed + 2)
    tests = [eval_metrics(pairs, split, rng_t) for _ in range(10)]
    test_ndcg = float(np.mean([t[0] for t in tests]))
    test_mrr = float(np.mean([t[1] for t in tests]))
    log(f"test NDCG {test_ndcg:.4f} MRR {test_mrr:.4f}")
    return _from_lead((test_ndcg, test_mrr), mesh)


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
    :func:`_train_epoch` (``step_ms``, ``step_ms_max``, ``wait_ms``).
    ``cfg.dp`` / ``tp`` / ``gp`` / ``pp`` above 1 run the parallel modes
    (:func:`make_exec`) on this rank of the process group; the returned
    ``state`` is the whole model and optimizer, current on rank 0."""
    dev = resolve_device(device)
    log = _lead_log(log)
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
    layout = shared_layout(lambda: make_layout(
        cfg, graph, sampler=sampler,
        seeds_fn=lambda: task.build_seeds(train_pairs, _crng)[0],
    ))
    task.layout = layout
    pads = pad_counts.read()
    log(f"layout: {_node_cap_text(layout)}, {layout.num_edges} padded "
        f"edges in {len(layout.blocks)} blocks; {task.n_classes} classes")
    em = EdgeStaticMeta.from_layout(layout)
    em_dev = em.to(dev)
    model = node_classifier(
        cfg, layout, _probe_in_dim(task, train_pairs, splits),
        task.n_classes, target_type, head_mode="seeds").to(dev)
    log(f"model parameters: {get_n_params(model):,}")
    tx = make_tx(cfg, model.named_parameters(), cfg.n_batch * cfg.repeat)
    from pyhgt_tpu_torch.train.step import kl_div_loss, nll_loss

    def head_loss(model_, h, labels, lmask):
        logp = model_.head(h)
        return (kl_div_loss(logp, labels, mask=lmask) if multi_label
                else nll_loss(logp, labels, mask=lmask))

    parts = _exec_parts(cfg, em_dev, head_loss,
                        lambda m: task.make_loss_fn(m, em_dev),
                        cfg.n_batch * cfg.repeat)
    full = TrainState(model, tx)
    step, loader_kw, state, mesh = make_exec(
        cfg, parts["loss_for"](model), tx, full, parts)
    fwd = make_eval_step(model)

    def eval_metrics(pairs_, split_, rng):
        tb = task.sample(pairs_, split_, rng)
        se = sort_batch(tb.sub, layout, em, with_backward=False)
        logp = sorted_logprobs(fwd, tb.sub.node_feat, tb.sub.node_mask, se,
                               em_dev, dev, raw_edges(model, tb.sub, dev))
        live = tb.label_mask
        if multi_label:
            rel = (np.asarray(tb.labels) > 0).astype(np.float64)
        else:
            rel = np.zeros((len(live), task.n_classes))
            rel[np.arange(len(live)), np.asarray(tb.labels)] = 1
        return ranking_metrics(logp[live], rel[live])

    start_epoch, ckpt, latest_path = _restore_latest(
        cfg, state, full, mesh, resume, log)
    producer = _producer_for(
        cfg, task.make_sample_fn(train_pairs, splits["train"]), layout, em)
    metrics = _metrics_logger(cfg)
    rng_eval = np.random.default_rng(cfg.seed + 1)

    def validate():
        ndcg, mrr = eval_metrics(valid_pairs, splits["valid"], rng_eval)
        return dict(valid_ndcg=ndcg, valid_mrr=mrr)

    history = _fit(cfg, producer, step, _label_step_args(dev, model),
                   loader_kw, validate, state, full, start_epoch, ckpt,
                   latest_path, dev, log, metrics, mesh)

    test_ndcg, test_mrr = _test_metrics(eval_metrics, test_pairs,
                                        splits["test"], cfg, log, mesh)
    metrics.log("test", ndcg=test_ndcg, mrr=test_mrr)
    metrics.close()
    log(_truncated_text(pads))
    return dict(history=history, test_ndcg=test_ndcg, test_mrr=test_mrr,
                best_valid=ckpt.best, state=full)


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
    task.layout = shared_layout(lambda: make_layout(
        cfg, graph, sampler=sampler,
        seeds_fn=lambda: task.build_seeds(
            pairs["train"], splits["train"], _crng
        )[0],
        seeds_bounded=False,
    ))
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
    ``edges_per_s``, ``step_ms``, ``step_ms_max``, ``wait_ms``); the
    parallel modes as there."""
    dev = resolve_device(device)
    log = _lead_log(log)
    splits = splits or OAG_SPLITS
    task, pairs, model = link_setup(cfg, graph, splits, first_meta,
                                    write_meta, max_group, log)
    layout = task.layout
    pads = pad_counts.read()
    log(f"layout: {_node_cap_text(layout)}, {layout.num_edges} padded "
        f"edges in {len(layout.blocks)} blocks; {len(task.groups)} name "
        f"groups")
    em = EdgeStaticMeta.from_layout(layout)
    em_dev = em.to(dev)
    model = model.to(dev)
    log(f"model parameters: {get_n_params(model):,}")
    tx = make_tx(cfg, model.named_parameters(), cfg.n_batch * cfg.repeat)
    from pyhgt_tpu_torch.tasks.link_prediction import grouped_listwise_loss

    def head_loss(model_, h, cand_idx, cand_mask, query_mask):
        return grouped_listwise_loss(model_.head(h, cand_idx), cand_mask,
                                     query_mask)

    parts = _exec_parts(cfg, em_dev, head_loss,
                        lambda m: make_link_loss_fn(m, em_dev),
                        cfg.n_batch * cfg.repeat)
    full = TrainState(model, tx)
    step, loader_kw, state, mesh = make_exec(
        cfg, parts["loss_for"](model), tx, full, parts)
    score_fn = make_eval_step(model)
    t = _as_dev(dev)

    def eval_metrics(pairs_, split_, rng):
        tb = task.sample(pairs_, split_, rng)
        se = sort_batch(tb.sub, layout, em, with_backward=False)
        scores = score_fn(t(tb.sub.node_feat), t(tb.sub.node_mask),
                          se.to(dev), em_dev, t(tb.cand_idx),
                          edges=raw_edges(model, tb.sub, dev)).cpu().numpy()
        live = tb.query_mask
        rel = np.zeros_like(scores)
        rel[:, 0] = 1.0
        scores = np.where(tb.cand_mask, scores, -np.inf)
        return ranking_metrics(scores[live], rel[live])

    start_epoch, ckpt, latest_path = _restore_latest(
        cfg, state, full, mesh, resume, log)
    producer = _producer_for(
        cfg, task.make_sample_fn(pairs["train"], splits["train"]), layout, em)
    rng_eval = np.random.default_rng(cfg.seed + 1)

    def validate():
        ndcg, mrr = eval_metrics(pairs["valid"], splits["valid"], rng_eval)
        return dict(valid_ndcg=ndcg, valid_mrr=mrr)

    def step_args(item):
        sub, tb = item.tb.sub, item.tb
        return (t(sub.node_feat), t(sub.node_mask), item.se, t(tb.cand_idx),
                t(tb.cand_mask), t(tb.query_mask),
                raw_edges(model, sub, dev))

    history = _fit(cfg, producer, step, step_args, loader_kw, validate,
                   state, full, start_epoch, ckpt, latest_path, dev, log,
                   None, mesh)

    test_ndcg, test_mrr = _test_metrics(eval_metrics, pairs["test"],
                                        splits["test"], cfg, log, mesh)
    log(_truncated_text(pads))
    return dict(history=history, test_ndcg=test_ndcg, test_mrr=test_mrr,
                best_valid=ckpt.best, state=full)


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
    (``step_ms``, ``step_ms_max``, ``wait_ms``); the parallel modes as in
    :func:`run_node_classification`, the test split evaluated on rank 0.
    """
    dev = resolve_device(device)
    log = _lead_log(log)
    sampler = make_sampler(cfg, graph, log=log)
    _crng = np.random.default_rng(cfg.seed + 7)
    _years = np.asarray(graph.aux["years"]).reshape(-1)

    def _cal_seeds():
        pick = _crng.choice(len(_years), min(cfg.batch_size, len(_years)),
                            replace=False)
        return {"paper": np.stack([pick, _years[pick]], axis=1)}

    layout = shared_layout(lambda: make_layout(
        cfg, graph, sampler=sampler, seeds_fn=_cal_seeds))
    pads = pad_counts.read()
    log(f"layout: {_node_cap_text(layout)}, {layout.num_edges} padded "
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
    from pyhgt_tpu_torch.train.step import nll_loss

    def head_loss(model_, h, labels, lmask):
        return nll_loss(model_.head(h), labels, mask=lmask)

    parts = _exec_parts(cfg, em_dev, head_loss,
                        lambda m: task.make_loss_fn(m, em_dev),
                        cfg.n_batch * cfg.repeat)
    full = TrainState(model, tx)
    step, loader_kw, state, mesh = make_exec(
        cfg, parts["loss_for"](model), tx, full, parts)
    fwd = make_eval_step(model)

    start_epoch, ckpt, latest_path = _restore_latest(
        cfg, state, full, mesh, resume, log)
    metrics = _metrics_logger(cfg)
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
                                   vtb.sub.node_mask, vse, em_dev, dev,
                                   raw_edges(model, vtb.sub, dev))
            accs.append(task.accuracy(logp, np.asarray(vtb.labels),
                                      np.asarray(vtb.label_mask)))
        return dict(valid_acc=float(np.mean(accs)))

    history = _fit(cfg, producer, step, _label_step_args(dev, model),
                   loader_kw, validate, state, full, start_epoch, ckpt,
                   latest_path, dev, log, metrics, mesh)

    # final multi-sample eval (eval_ogbn_mag.py:128-179), on rank 0
    def eval_forward(params, nf, es, et, dt, emk, nmk):
        se = sort_edges(es, et, dt, emk, layout, em, with_backward=False)
        return sorted_logprobs(
            make_eval_step(params), nf, nmk, se, em_dev, dev,
            raw_edges(params, (es, et, dt, emk), dev))

    vr = None
    if world()[0] == 0:
        vr = multi_sample_eval(
            eval_forward, model, task, split="test",
            batch_size=cfg.batch_size,
            vr_num=cfg.vr_num if eval_mode == "variance_reduce" else 1,
            rng=np.random.default_rng(cfg.seed + 3),
            max_nodes=max_eval_nodes,
        )
    vr = _from_lead(vr, mesh)
    metrics.log("test", mode=eval_mode, **{k: v for k, v in vr.items()})
    metrics.close()
    log(f"test acc ({eval_mode}): {vr['acc']:.4f} "
        f"(sequential {vr['seq_acc']:.4f}, per-occurrence "
        f"{vr['single_sample_acc']:.4f}, n={vr['n_eval']})")
    log(_truncated_text(pads))
    return dict(history=history, test=vr, best_valid=ckpt.best, state=full)


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
