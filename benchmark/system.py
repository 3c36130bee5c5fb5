"""The system under test, assembled from a configuration file as the
port's runners assemble it (``experiments/engine.py``: ``run_ogbn`` and
``run_node_classification`` up to their epoch loop): the proxy graph, the
C++ sampler, the calibrated layout, the task, the model, AdamW, the step
of ``engine.make_exec`` and the loader's producer. What the benchmark
changes: the graph and the layout's calibration draws are seeded from the
configuration, the weights are the benchmark's (:mod:`benchmark.weights`),
and the loader's producer also hands over what the harness counts.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import numpy as np
import torch

from benchmark import flops, kernel_bytes, weights
from pyhgt_tpu_torch.config import PRESETS, ExperimentConfig
from pyhgt_tpu_torch.datasets import mag_proxy, oag_proxy
from pyhgt_tpu_torch.datasets.features import feature_mag, feature_oag
from pyhgt_tpu_torch.experiments import engine
from pyhgt_tpu_torch.graph.container import NO_TIME
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.sampling.native import NativeHGSampler
from pyhgt_tpu_torch.tasks.base import TimeSplit, build_time_split_pairs
from pyhgt_tpu_torch.tasks.node_classification import NodeClassificationTask
from pyhgt_tpu_torch.tasks.ogbn import OgbnNodeTask
from pyhgt_tpu_torch.train.loader import PrefetchLoader
from pyhgt_tpu_torch.train.step import TrainState

GRAPHS = {"mag_proxy": mag_proxy.build, "oag_proxy": oag_proxy.build}
FEATURES = {"mag": feature_mag, "oag": feature_oag}


def experiment_config(cfg: dict, seed: int) -> ExperimentConfig:
    """The preset with every field the configuration file sets."""
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    over = {k: v for k, v in cfg.items() if k in fields}
    return PRESETS[cfg["preset"]].replace(**over, seed=int(seed) % (2**31))


class _SeededDraws:
    """The sampler with every draw taken from one generator:
    ``PadSpec.calibrate`` calls ``sample_raw`` without one."""

    def __init__(self, sampler, rng: np.random.Generator):
        self.sampler, self.rng = sampler, rng
        self.schema = sampler.schema

    def sample_raw(self, seeds, **kw):
        return self.sampler.sample_raw(seeds, rng=self.rng, **kw)


class _Recorder:
    """The sampler, keeping the raw sample of the last call on each
    thread (the sampled node ids, which the reference judges)."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.schema = sampler.schema
        self.local = threading.local()

    def sample_raw(self, seeds, **kw):
        raw = self.sampler.sample_raw(seeds, **kw)
        self.local.raw = raw
        return raw


class Carry:
    """What rides beside a loader item without being copied to the card:
    the host counts of the item and, when recorded, its raw sample and
    host arrays."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def plain_graph(graph) -> dict:
    """The graph as the reference reads it: plain arrays, no program
    objects."""
    return dict(
        types=list(graph.schema.node_types),
        metas=[m.as_tuple() for m in graph.schema.metas],
        num_nodes=dict(graph.num_nodes),
        adj={m: (a.indptr, a.src, a.time) for m, a in graph.adj.items()},
        features=graph.features, aux=graph.aux, no_time=NO_TIME)


@dataclasses.dataclass
class System:
    cfg: dict
    ecfg: ExperimentConfig
    graph: Any
    layout: Any
    task: Any
    model: torch.nn.Module
    optimizer: Any
    step: Callable
    step_args: Callable
    producer: Callable          # rng -> staged item (the runners' feed)
    recorder: _Recorder
    em: EdgeStaticMeta
    in_dim: int
    n_classes: int
    device: torch.device

    def layout_blocks(self):
        """``(tgt, src, rel, start, cap)`` of every padded block."""
        return [(b.meta.tgt_type, b.meta.src_type, b.meta.rel, b.start,
                 b.cap) for b in self.layout.blocks]

    def host_counts(self, item) -> dict:
        """Valid nodes per type and valid edges per block of a staged item,
        its FLOPs and the bytes of its kernels' launches."""
        sub, se = item.tb.sub, item.se
        types = self.layout.schema.node_types
        nodes = {t: int(c) for t, c in zip(types, sub.node_mask.sum(1))}
        blocks = []
        for b in self.layout.blocks:
            e = int(sub.edge_mask[b.start:b.start + b.cap].sum())
            blocks.append((b.meta.tgt_type, b.meta.src_type, e))
        c = self.ecfg
        rows = (nodes[self.cfg["target_type"]] if self.cfg["head"] == "full"
                else c.batch_size)
        fl = flops.train_step_flops(nodes, blocks, self.in_dim, c.n_hid,
                                    c.n_heads, c.n_layers, rows,
                                    self.n_classes)
        E, L = self.layout.num_edges, c.n_layers
        elem = 2 if c.edge_bf16 else 4
        pair = softmax = None
        pair_launches = 0
        if c.seg_pallas and se.pseg_src is not None:
            tab = se.ptab_src if se.ptab_src is not None else se.pseg_tab
            pair = L * sum(kernel_bytes.partials_bytes(E, c.n_hid, elem, a, 2)
                           for a in (se.pseg_src, tab) if a is not None)
            pair_launches = L * sum(a is not None for a in (se.pseg_src, tab))
        if c.softmax_pallas and se.pseg_tgt is not None \
                and se.pseg_tgt.live_key is not None and not se.pseg_tgt.v:
            softmax = L * kernel_bytes.softmax_partials_bytes(
                E, c.n_heads, se.pseg_tgt)
        return dict(nodes=nodes, edges=sum(e for _, _, e in blocks),
                    flops=fl, pair_bytes=pair,
                    pair_launches=pair_launches,
                    softmax_bytes=softmax,
                    softmax_launches=L if softmax else 0,
                    targets=c.batch_size)

    def loader(self, seed: int, repeat: int, traffic: dict,
               record: bool = False) -> PrefetchLoader:
        """A ``PrefetchLoader`` over the runners' staged producer, as
        ``engine._loader`` builds it; each item comes as ``(item,
        Carry)``. ``record`` keeps each item's raw sample and host
        arrays in its carry."""

        def fn(rng):
            item = self.producer(rng)
            carry = Carry(counts=self.host_counts(item))
            if record:
                carry.raw = self.recorder.local.raw
                carry.host = item
            return item, carry

        return PrefetchLoader(fn, n_workers=traffic["n_pool"],
                              queue_size=traffic["queue_size"],
                              repeat=repeat, seed=seed, device=self.device)


# keeps the text embeddings' stream apart from any other use of a seed
EMB_STREAM = 0x0E4B_0001
EMB_ROWS = 1 << 16


def make_graph(cfg: dict, device="cpu"):
    """The configuration's graph, from its own seed; with ``emb_dim``,
    every node type's ``emb`` column drawn again at that width
    (:func:`widen_emb`)."""
    graph = GRAPHS[cfg["graph"]](cfg["graph_scale"], cfg["graph_seed"])
    if "emb_dim" in cfg:
        widen_emb(graph, cfg["emb_dim"], cfg["graph_seed"], device)
    return graph


def widen_emb(graph, width: int, seed: int, device) -> None:
    """Replace each node type's ``emb`` column by ``[n, width]`` normal
    values at the old column's standard deviation: the source's text
    embeddings are wider than the proxy draws them. One generator on
    ``device`` seeded by ``seed``, in blocks of :data:`EMB_ROWS` rows."""
    device = torch.device(device)
    gen = weights.generator(seed, device, EMB_STREAM)
    for t in sorted(graph.features):
        cols = graph.features[t]
        old = np.asarray(cols["emb"])
        std = float(old[:4096].std())
        out = np.empty((len(old), width), np.float32)
        for lo in range(0, len(out), EMB_ROWS):
            n = min(EMB_ROWS, len(out) - lo)
            out[lo:lo + n] = (torch.randn((n, width), generator=gen,
                                          device=device) * std).cpu().numpy()
        cols["emb"] = out


def build(cfg: dict, seed: int, device, log=print, graph=None) -> System:
    """The system under test of configuration ``cfg`` with the weights of
    ``seed``, on ``device`` (``graph``: :func:`make_graph`'s, if built)."""
    ecfg = experiment_config(cfg, seed)
    if graph is None:
        graph = make_graph(cfg, device)
    sampler = engine.make_sampler(ecfg, graph, log=log)
    if not isinstance(sampler, NativeHGSampler):
        raise RuntimeError("the C++ sampler did not load")
    cal = _SeededDraws(sampler, np.random.default_rng(cfg["layout_seed"]))
    seeds_rng = np.random.default_rng(cfg["layout_seed"] + 7)
    recorder = _Recorder(sampler)
    target = cfg["target_type"]
    if cfg["task"] == "ogbn_mag":
        years = np.asarray(graph.aux["years"]).reshape(-1)

        def seeds_fn():
            pick = seeds_rng.choice(len(years), ecfg.batch_size,
                                    replace=False)
            return {target: np.stack([pick, years[pick]], axis=1)}

        layout = engine.make_layout(ecfg, graph, sampler=cal,
                                    seeds_fn=seeds_fn)
        task = OgbnNodeTask(graph=graph, sampler=recorder, layout=layout,
                            target_type=target, batch_size=ecfg.batch_size)
        sample_fn = task.make_sample_fn("train")
    elif cfg["task"] == "paper_field":
        split = TimeSplit(hi=cfg["train_split"]["hi"])
        task = NodeClassificationTask(
            graph=graph, sampler=recorder, layout=None, target_type=target,
            label_meta=tuple(cfg["label_meta"]),
            batch_size=ecfg.batch_size, multi_label=cfg["loss"] == "kl",
            feature_fn=FEATURES[cfg["features"]])
        pairs = build_time_split_pairs(graph, task.rev_label_meta,
                                       {"train": split})["train"]
        layout = engine.make_layout(
            ecfg, graph, sampler=cal,
            seeds_fn=lambda: task.build_seeds(pairs, seeds_rng)[0])
        task.layout = layout
        sample_fn = task.make_sample_fn(pairs, split)
    else:
        raise ValueError(f"no task {cfg['task']!r}")
    in_dim = int(FEATURES[cfg["features"]](graph, target,
                                           np.arange(1)).shape[1])
    em = EdgeStaticMeta.from_layout(layout)
    em_dev = em.to(device)
    model = engine.node_classifier(
        ecfg, layout, in_dim, task.n_classes, target,
        head_mode=cfg["head"]).to(device)
    weights.load_into(model, seed, device)
    steps_per_epoch = ecfg.n_batch * ecfg.repeat
    opt = engine.make_tx(ecfg, model.named_parameters(), steps_per_epoch)
    step, _, _, _ = engine.make_exec(ecfg, task.make_loss_fn(model, em_dev),
                                     opt, TrainState(model, opt))
    producer = engine._staged(engine._producer_for(ecfg, sample_fn, layout,
                                                   em))
    return System(cfg, ecfg, graph, layout, task, model, opt, step,
                  engine._label_step_args(device, model), producer, recorder,
                  em, in_dim, task.n_classes, device)
