"""Experiment configuration: one dataclass holding every knob, and the
per-task presets.

A copy of :mod:`pyhgt_tpu.config` (a plain dataclass, no framework), field
for field, so the port's CLI (:mod:`pyhgt_tpu_torch.run`) accepts the same
flags as the JAX package's. ``dp``, ``tp``, ``gp``, ``pp`` (``pp_micro``)
and ``gp_overlap`` run the parallel modes, one process per rank
(:func:`pyhgt_tpu_torch.experiments.engine.make_exec`; tp with gp or pp
raises, as in the JAX package). ``fused_opt`` selects the
flattened-vector AdamW, ``param_bf16`` bf16 weight banks in the training
loss with f32 masters, ``remat`` the recompute of each HGT conv's edge
core in the backward, in every mode. ``conv_name`` picks any conv of the
JAX package and ``edge_impl`` its edge path (``sorted``, the default here,
or ``segment``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ExperimentConfig:
    # -- data -------------------------------------------------------------
    data_path: str = ""                # CSRGraph pickle (or reference .pk)
    model_dir: str = "./model_save"    # --model_dir (train_paper_field.py:15)
    task_name: str = "paper_field"
    domain: str = "_CS"                # --domain (train_paper_field.py:17)
    data_percentage: float = 1.0       # --data_percentage (:55-56)

    # -- model ------------------------------------------------------------
    conv_name: str = "hgt"             # --conv_name (:26-28)
    n_hid: int = 400                   # --n_hid (:30-31)
    n_heads: int = 8                   # --n_heads (:32-33)
    n_layers: int = 4                  # --n_layers (:34-35)
    dropout: float = 0.2               # --dropout (:36-37)
    prev_norm: bool = False            # --prev_norm (ogbn flags :60)
    last_norm: bool = False            # --last_norm (:61)
    use_rte: bool = True               # --use_RTE
    edge_impl: str = "sorted"
    remat: bool = False
    save_kv: bool = False
    edge_bf16: bool = False            # sorted path: per-edge stage in bf16
                                       # (f32 softmax + accumulations)
    edge_bwd: str = "permute"          # sorted-path backward strategy
                                       # (ops/sorted_hgt._edge_bwd)
    seg_pallas: bool = False           # sorted path: the live_partials
                                       # kernel for wide [E, D] reductions
    softmax_pallas: bool = False       # segment_softmax_partials kernel
                                       # (needs the legacy target aux)
    param_bf16: bool = False           # bf16 weight banks at apply time,
                                       # f32 masters (optim.bf16_param_cast)
    tgt_rank_cap: int = 0              # kernel tgt-grouping rank cap V
                                       # (0 = off): narrows the kernel
                                       # aux from K+W to 2V when live
                                       # rows/tile stay under V; batches
                                       # that violate it fall back to the
                                       # legacy width (one retrace). Size
                                       # like edge caps: measure max live
                                       # rows/tile on calib draws, add
                                       # ~30% headroom.
    src_rank_cap: int = 0              # src-grouping rank cap (singleton
                                       # split: degree-1 sources route
                                       # through a gather; multi ranks
                                       # must stay under the cap)
    src_split_cap: int = 0             # two-region src reduction: meta
                                       # blocks through a kernel capped
                                       # at this rank, the self-block
                                       # tail through a plain CSR (needs
                                       # tile-aligned meta caps; falls
                                       # back per batch otherwise)
    tab_cap: int = 0                   # tab compaction: per-block
                                       # occupied-Δt rank remap of the
                                       # RTE table space (multiple of 8;
                                       # falls back per batch if a block
                                       # occupies more Δt slots). A
                                       # round-4 worker-kernel-fault
                                       # landmine here was root-caused
                                       # to the compact-table gather's
                                       # duplicate-index scatter-add
                                       # transpose and FIXED (one-hot
                                       # matmul selection) — see
                                       # docs/PERF_NOTES.md round-4b and
                                       # docs/runs/ogbn_mag_proxy_r4.json.
    softmax_tilemax: str = ""          # "" | "on" | "auto": per-tile-max
                                       # online softmax; "auto" adds a
                                       # runtime spread guard + fallback

    # -- sampling ---------------------------------------------------------
    sample_depth: int = 6              # --sample_depth (:38-39)
    sample_width: int = 128            # --sample_width (:40-41)
    batch_size: int = 256              # --batch_size (:51-52)
    n_batch: int = 32                  # --n_batch (:47-48)
    repeat: int = 2                    # --repeat (:49-50)
    n_pool: int = 4                    # --n_pool (:45-46)
    native_sampler: bool = True

    # -- optimization -----------------------------------------------------
    optimizer: str = "adamw"           # --optimizer (:42-44)
    fused_opt: bool = False            # flattened-vector AdamW (same math,
                                       # one wide kernel chain; train/optim)
    scheduler: str = "cosine"          # cosine (OAG, clamps at period end —
    # documented deviation) | cosine_torch (exact torch oscillation +
    # train_step=1500 mid-cycle start) | onecycle (ogbn :128)
    max_lr: float = 1e-3               # onecycle peak 5e-4 on ogbn (:128)
    onecycle_pct_start: float = 0.05   # warmup fraction (reference :128;
    # torch's own default is 0.3 — measurably better on some tasks,
    # docs/runs/hard_task_schedule_ab.json)
    onecycle_anneal: str = "linear"    # linear (reference) | cos (torch
    # default shape)
    onecycle_final_div: float = 10.0   # final_div_factor (reference :128;
    # torch default 1e4)
    n_epoch: int = 200                 # --n_epoch (:23-24)
    clip: float = 0.25                 # --clip (:61-62; ogbn uses 1.0 :57)
    weight_decay: float = 0.01

    # -- parallelism (no reference analogue — reference is single-GPU,
    # SURVEY §2.9; in the JAX package they drive device meshes) -------------
    dp: int = 1                        # data-parallel shards per step:
                                       # each step consumes dp stacked
                                       # subgraphs via a shard_map'd
                                       # unbatched program (parallel/spmd)
    tp: int = 1                        # tensor-parallel (head-axis) shards
                                       # via GSPMD param sharding
                                       # (parallel/mesh rules)
    gp: int = 1                        # graph-axis (edge-partition) shards:
                                       # one oversized subgraph's sorted
                                       # edges split contiguously across
                                       # devices, boundary stats psum over
                                       # ICI (parallel/edge_partition — the
                                       # SP analogue, SURVEY §2.9)
    pp: int = 1                        # pipeline stages: the conv stack
                                       # split over a 'pipe' mesh axis,
                                       # GPipe microbatch schedule
                                       # (parallel/pipeline); composes
                                       # with dp; needs n_layers % pp == 0
                                       # and prev_norm == last_norm
    pp_micro: int = 0                  # microbatches per pp step
                                       # (0 = 2*pp; bubble = (pp-1)/(M+pp-1))
    gp_overlap: bool = False           # gp: boundary exchange as a manual
                                       # chunked ppermute ring (reduce-
                                       # scatter + all-gather) instead of
                                       # XLA psum — the ICI-pipelinable
                                       # form (parallel/edge_partition)

    # -- eval -------------------------------------------------------------
    vr_num: int = 8                    # eval_ogbn_mag.py:95
    seed: int = 43                     # np.random.seed(43) (:179)

    # -- padding (static batch shapes; no reference analogue) ---------------
    node_cap: Optional[int] = None     # default: seeds + depth*width
    edge_cap: Optional[int] = None     # default: node_cap * 8
    calibrate_caps: bool = True        # measure real sample draws to size
                                       # per-meta edge caps (PadSpec.calibrate);
                                       # default ON so the static node_cap*8
                                       # heuristic can't silently drop edges

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# Per-task presets pinning each reference script's defaults.
PRESETS = {
    # OAG/train_paper_field.py:9-62
    "paper_field": ExperimentConfig(task_name="paper_field"),
    # OAG/train_paper_venue.py (same defaults, NLL head)
    "paper_venue": ExperimentConfig(task_name="paper_venue"),
    # OAG/train_author_disambiguation.py (Matcher head)
    "author_disambiguation": ExperimentConfig(task_name="author_disambiguation"),
    # ogbn-mag/train_ogbn_mag.py:21-64 + README.md:16-24 reproduction recipe
    "ogbn_mag": ExperimentConfig(
        task_name="ogbn_mag",
        n_hid=512, n_heads=8, n_layers=4,
        prev_norm=True, last_norm=True, use_rte=True,
        sample_depth=6, sample_width=520,
        batch_size=128, n_batch=32, repeat=2,
        scheduler="onecycle", max_lr=5e-4, clip=1.0,
        n_epoch=100,
        save_kv=True,  # custom-VJP residuals are node-level; saving the
        # per-edge K/V/Q removes 3 backward HBM gathers per layer
    ),
}
