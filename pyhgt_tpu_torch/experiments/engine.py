"""Shared experiment assembly: sampler, batch layout, model and optimizer
from an :class:`~pyhgt_tpu_torch.config.ExperimentConfig`.

Counterpart of the helpers of :mod:`pyhgt_tpu.experiments.engine` that
serving needs (``make_sampler``, ``make_layout``, ``gnn_kwargs``,
``make_tx``, ``_infer_in_dim``), plus ``node_classifier`` (the model the
JAX package's predictor and ``run_ogbn`` build inline) and
``check_ported``; the epoch loop, the evaluators and the runners come with
the training loop.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.graph.schema import PadSpec
from pyhgt_tpu_torch.models.composite import NodeClassifierModel
from pyhgt_tpu_torch.sampling.batch import BatchLayout
from pyhgt_tpu_torch.sampling.hgsampler import HGSampler
from pyhgt_tpu_torch.train.optim import (
    cosine_schedule,
    cosine_torch_schedule,
    make_optimizer,
    onecycle_schedule,
)


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
