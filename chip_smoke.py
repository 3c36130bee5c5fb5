"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile]

Drives ``pyhgt_tpu_torch`` (never JAX) through its main paths at the
``bench`` preset (ogbn-mag reproduction widths: 4 HGT layers, n_hid 512,
8 heads, RTE, bf16 edge stage), the ``ogbn_mag`` preset and the OAG
presets, and checks every hand-written kernel on them:

1. build the six CUDA kernels from ``pyhgt_tpu_torch/csrc`` (nvcc, sm_90a),
   one compiler process per source, all started together;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (aux of a real sorted bench batch), each in
   bf16 and f32: ``live_partials`` on the capped and legacy target aux;
   ``live_partials_pair`` on the src runs aux, the compacted and the
   uncompacted tab-window aux, the tab runs aux and a singleton-split aux
   with dead rows; ``live_partials_slab`` on the src runs aux and the
   tab-window aux; ``live_partials_weighted`` on the capped and legacy
   target aux and a singleton-split aux; ``head_sum_product``;
   ``segment_softmax_partials`` on the legacy target aux with the batch's
   masked rows at -1e30; the softmax and the three walks
   (``live_partials``, pair, slab) on a runs aux on outputs whose memory
   held NaN (every row written, unreached rows exactly 0, two calls
   bit-identical); then the walks on the hard layouts of
   ``sampling/seg_cases.py`` (a whole-tile run, runs across every block
   boundary, a row per run, rows that skip values, dead rows with all-dead
   tiles, the window at W = V = 240) at 6, 72 and 138 tiles, and each
   walk wrapper's host time per call;
3. time each kernel, its plain version and the PyTorch calls that compute
   the same function, beside the card's bound for the work; the walks with
   their launch (S blocks per tile, grid, threads, shared memory) as the
   eager wrapper (20 calls) and as device time (8 calls on 8 copies of the
   inputs in one CUDA graph, cold L2), as the softmax kernel;
4. serve: answer 3 requests (synthetic batch -> host sort -> forward ->
   argmax over the 128 seeds, as ``OgbnPredictor.predict`` does per chunk),
   counting kernel launches;
5. compare one request's log-probs from the card with the same forward on
   the CPU (the plain path);
6. train: one warm-up step and 3 timed steps of the flagship trainer (the
   step ``python3 -m pyhgt_tpu_torch.bench`` times: forward with dropout,
   NLL, backward, global-norm clip, AdamW), counting kernel launches and
   checking losses, gradients and that the parameters moved;
7. compare one loss and every parameter's gradient (dropout off) from the
   card with the CPU's plain path;
8. the same trainer under three more configurations, launch counts
   asserted: (A) ``edge_bwd="slab"``, (B) ``WEIGHTED_KERNEL`` on, (C)
   ``seg_rank_cap=0, softmax_pallas=True``, each followed by one served
   request under the same configuration with its launches asserted; for
   each, and for ``edge_bwd`` recompute and src_direct and
   ``softmax_tilemax="auto"`` (three steps each as well), loss and gradients
   on the card against the main path's on the card, and for (A)-(C) against
   the CPU's plain path;
9. one standalone call of ``head_sum_product`` (no path of the package
   calls it) on a layer's gathered rows, against the edge stage's own
   ``_head_sum_prod``;
10. serve for real at the ``ogbn_mag`` preset under ``--seg_pallas
   --edge_bf16 --softmax_pallas``: build the ogbn-mag proxy at scale 0.1,
   write it with ``save_dir`` and read it back memory-mapped, write a
   checkpoint of a seeded ``NodeClassifierModel`` and restore it into an
   ``OgbnPredictor`` (bit-equal), answer 8 JSON-lines requests through
   ``serve_jsonl`` (1, 16, 128 and 256 nodes at ``vr_num`` 1 and 2; the C++
   sampler, ``pad_sample``, the C++ host sort, the forward on the card)
   timing each part, with ``live_partials`` and
   ``segment_softmax_partials`` launched once per layer per forward and the
   C++ entry points once per forward; sort one served batch by both host
   paths (bit-equal); the same request on a CPU predictor; a coalesced
   burst of 4 requests (one predictor call); and
   ``python -m pyhgt_tpu_torch.run serve`` as a subprocess;
11. train for real at the ``ogbn_mag`` preset's full width with the same
   flags, on the same proxy graph: ``run_ogbn`` cut in length only (2
   epochs of 6 batches x ``repeat`` 2, the loader's 4 threads sampling and
   sorting with the backward's aux, 4 validation batches per epoch, best
   and ``latest`` checkpoints, the metrics jsonl, the VR test evaluation
   of 256 papers at ``vr_num`` 2), printing per epoch the step time, the
   consumer's wait on the loader, train edges/s, valid accuracy and the
   edges the caps dropped, with every launch asserted; a resumed run that
   trains exactly one more epoch; one producer item's loss and global
   gradient norm on the card against the CPU's plain path (dropout 0);
   ``evaluate_ogbn`` of the best checkpoint in both modes; that
   checkpoint served by an ``OgbnPredictor``; and the path's kernels
   (``live_partials``, the pair and the slab on the src runs and
   tab-window aux, ``segment_softmax_partials``) held against their plain
   versions and timed on one item of the calibrated layout (D = 512);
12. the OAG task family at the presets' full width (n_hid 400, 8 heads, 4
   layers, depth 6, width 128, batch 256) with the same flags, on the OAG
   proxy (the repo's ``examples/oag_scale_proxy.py`` build) at scale 0.1,
   its authors named ``name{a % (n_author // 16)}``, written with
   ``save_dir`` and read back memory-mapped; each run cut in length only
   (1 epoch of 4 batches x ``repeat`` 2): ``[oag-field]``
   ``run_node_classification`` at the ``paper_field`` preset with
   ``feature_oag`` (529-wide input) and a resumed epoch, ``[oag-venue]``
   ``run.main(["paper_venue", ...])`` (the NLL head), ``[oag-link]``
   ``run_author_disambiguation``; per epoch the step time, the loader
   wait, train edges/s, valid and test NDCG/MRR and the dropped edges,
   every launch asserted (per step and per validation or test forward, as
   on the ogbn-mag path); for the field and link runners one producer
   item's loss, global gradient norm and forward outputs (representations,
   and the log-probs or ``score_pairs``) against the CPU; the paper-field
   steps' pace on items already on the card (no loader wait); and the three
   kernels of the path (``live_partials``, ``live_partials_pair`` on the
   runs and window aux, ``segment_softmax_partials``) held against their
   plain versions on a real batch at the path's widths and timed (not the
   slab: its contract takes 128-aligned halves, and D = 400);
13. ``[link-serve]``: a ``LinkPredictor`` restored from ``[oag-link]``'s
   best checkpoint indexes 2,048 grouped authors (ms per chunk), then
   answers 8 JSON-lines requests of 1-256 papers through
   ``serve_link_jsonl``, timed by part (sampler, host sort, forward, score
   + top-k), launches asserted, the top-k scores against a float64
   recomputation of the index product;
14. ``[convs]``: every other conv of the JAX package (``dense_hgt``,
   ``gcn``, ``gat``, ``rgcn``, ``han``, ``hetgnn``) trained by
   ``run_node_classification`` at the paper_field preset's full width on
   the OAG proxy, 2 steps, its validation batch and 10 test batches each,
   printing the step, the peak memory and the loss, launches asserted
   (DenseHGT's are HGT's, the baselines launch none), and one item's loss
   and gradient norm against the CPU;
15. ``[segment]``: HGT on the segment edge path (``--edge_impl segment``),
   2 steps, no kernel launched, and one item's loss against the sorted
   path's on the same weights;
16. ``[dense-hgt-ogbn]``: ``run ogbn_mag --conv_name dense_hgt`` with the
   slice's flags on the ogbn-mag proxy (1 epoch of 3 batches x 2, the test
   split at ``vr_num`` 1), then ``run serve`` of its checkpoint answering 3
   requests, launches asserted per step and per forward;
17. ``[preprocess-oag]``: synthetic OAG TSVs in the reference layout
   (12,000 papers, an L1/L2 field hierarchy, authors, affiliations,
   venues, pretrained vectors, names) through ``run preprocess_oag``, then
   ``run paper_field`` on the built graph for 2 steps at full width;
18. ``[convert]``: a graph pickled as the reference pickles it, read by
   ``run``'s ``load_graph`` through the converter and sampled once;
19. ``[gp-kernels]``: the bench batch sorted as a gp run sorts it and cut
   into 2 shards (113,280 edges, 295 tiles each, the preset's caps per
   shard): ``live_partials`` on each shard's target aux and
   ``live_partials_pair`` on its src runs aux and on the tab aux its step
   reads (the runs aux: its tiles span more than two meta blocks) against
   their plain versions, bf16 and f32, and timed beside each shard's
   bound; ``[gp-window]`` the pair on a gp shard's tab-window aux, from an
   ``[ogbn]`` path item cut in 2;
20. ``[gp]``, ``[dp]``, ``[pp]``: one 2-rank gloo world on cuda:0, spawned
   once, at the bench preset's full width (dropout 0, TF32 off): gp = 2 on
   the seed-0 batch, dp = 2 on seeds 0 and 1, pp = 2 on seeds 0-3
   (``pp_micro`` 4); each rank's loss and every gradient it holds against
   the single-process step on the card (same inputs and weights), the
   parameters after one update equal on both ranks, the launches per rank
   of a step asserted, the per-rank step and peak memory beside the single
   process's, and the gloo all-reduces of one gp layer timed;
21. ``[gp-run]``: ``torchrun --nproc_per_node 2 -m pyhgt_tpu_torch.run
   ogbn_mag --gp 2 --dist_backend gloo`` with the slice's flags on the
   ogbn-mag proxy (1 epoch of 2 x 2 steps, the test split at ``vr_num``
   1), then ``run serve`` of rank 0's checkpoint answering 2 requests;
   ``[pp-run]``: ``run paper_field --pp 2`` (4 microbatches a step) and
   ``[dp-gp-run]``: ``run paper_field --dp 2 --gp 2`` (4 ranks) on the OAG
   proxy (1 epoch of 2 steps); every rank's launches asserted;
22. ``[tp]`` (in the world of item 20): tp = 2 on the seed-0 batch, each
   rank a sharded copy of the flagship (D / tp columns, H / tp heads); the
   loss and every gradient, gathered over the model group, against the
   single process; the replicated parameters equal on both ranks after the
   update; launches, step, peak memory and one tp layer's gloo collectives;
   ``[determinism]`` lines: the single process and a tp rank each against
   itself on the same batch and weights; ``[tp-kernels]``: the walks and
   the softmax partials at a tp rank's widths (the bench batch and an
   ``[ogbn]`` item at D 256, a paper-field item at D 200 and 4 heads)
   against their plain versions and timed beside their bounds;
   ``[tp-run]``: ``run paper_field --tp 2`` (1 epoch of 2 steps), its
   second epoch resumed in a 2-rank world (``resume=True``), rank 0's
   checkpoint loaded by one process on the card, which answers a batch; ``[dp-tp-run]``: ``run
   paper_field --dp 2 --tp 2`` (4 ranks, 1 epoch of 2 steps); every rank's
   launches asserted;
23. the training-step extras at the bench preset, each against the default
   step in this run (after item 8): ``[fused-opt]`` the flattened-vector
   AdamW's parameters after 3 updates from the default AdamW's gradients
   (rtol 1e-5, atol 1e-6), ms per train step of both in turns, and ms of
   ``optimizer.step()`` alone for both and for the library's
   ``AdamW(fused=True)`` under the same clip (timed only); ``[param-bf16]``
   loss and gradients with bf16 weight banks against the f32 step (rtol
   2e-2, GRAD_TOL), every gradient f32, the dtype each kernel receives, ms
   per step, peak memory and launches of both; ``[remat]`` gradients with
   the edge core recomputed against the step without (SPREAD_TOL, the
   card's run-to-run spread) beside that step's own spread, ms per step,
   peak memory and launches (live_partials 3 a layer) of both, and
   ``[remat-ogbn]`` the same on an ``[ogbn]`` item (the softmax kernel's
   recompute: 2 a layer); ``[acc]`` ``make_train_step_acc`` with A = 2
   against a hand-made step on the averaged gradients (the mean loss, the
   gradients the update reads), ms of one accumulated step against two
   default steps;
24. ``[tp-extras-run]`` ``run paper_field --tp 2 --fused_opt --param_bf16
   --remat``, ``[pp-extras-run]`` ``run ogbn_mag --pp 2 --fused_opt
   --remat`` and ``[gp-extras-run]`` ``run ogbn_mag --gp 2 --remat`` under
   torchrun (started with item 21's runs, 1 epoch each), each then resumed
   for a second epoch from rank 0's ``latest`` checkpoint in a spawned
   2-rank world, every rank's launches asserted in both (the recompute's
   included).

Any failed phase raises (exit code != 0). The line before the last carries
the card's name and power limit, the one before it the kernels' JSON; the
last line is ``{"ok": true, "device": {...}}``. ``--profile`` also prints
the top CUDA ops of one forward, of one train step, of one step under
``edge_bwd="slab"``, of one forward under ``softmax_pallas``, of one
``segment_softmax_partials`` call and of one predictor request by device
time (torch.profiler), the card's idle share over the train steps of the
resumed ogbn-mag and paper-field epochs, and the idle share of paper-field
steps on items already on the card (no loader wait).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import pickle
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pyhgt_tpu_torch import run as run_cli
from pyhgt_tpu_torch.bench import make_flagship_trainer
from pyhgt_tpu_torch.config import PRESETS
from pyhgt_tpu_torch.datasets.features import feature_oag, oag_in_dim
from pyhgt_tpu_torch.datasets.mag_proxy import build as build_proxy
from pyhgt_tpu_torch.datasets.oag_proxy import build as build_oag_proxy
from pyhgt_tpu_torch.experiments.engine import (
    OAG_SPLITS, TRAIN_SPAN, _label_step_args, _loader, _make_producer,
    _producer_for, _train_epoch, evaluate_ogbn, link_matcher, make_layout,
    make_sampler, make_tx, node_classifier, raw_edges,
    run_author_disambiguation, run_node_classification, run_ogbn,
)
from pyhgt_tpu_torch.experiments.serving import (
    LinkPredictor, OgbnPredictor, serve_jsonl, serve_link_jsonl,
)
from pyhgt_tpu_torch.flagship import PRESETS as PRESETS_FL
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.models.model import SORTED_CONVS
from pyhgt_tpu_torch.native import build as native_build
from pyhgt_tpu_torch.ops import cuda_build, sorted_hgt
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.ops import pallas_seg as ps
from pyhgt_tpu_torch.ops.pallas_seg import (
    PallasSegAux, out_rows, live_partials, live_partials_pair,
    live_partials_pair_plain, live_partials_plain,
)
from pyhgt_tpu_torch.sampling.batch import pad_sample
from pyhgt_tpu_torch.sampling.hgsampler import HGSampler
from pyhgt_tpu_torch.sampling.seg_cases import (
    CASES as HARD_CASES, adversarial_auxes, on_nan_memory,
)
from pyhgt_tpu_torch.sampling.sorted_batch import (
    pallas_seg_aux_split, sort_batch, sort_edges,
)
from pyhgt_tpu_torch.tasks.base import build_time_split_pairs, gather_features
from pyhgt_tpu_torch.tasks.evaluate import multi_sample_eval
from pyhgt_tpu_torch.tasks.link_prediction import (
    LinkPredictionTask, build_link_pairs, build_name_groups,
    make_link_loss_fn,
)
from pyhgt_tpu_torch.tasks.node_classification import NodeClassificationTask
from pyhgt_tpu_torch.tasks.ogbn import OgbnNodeTask
from pyhgt_tpu_torch.train.checkpoint import save_checkpoint
from pyhgt_tpu_torch.train.log import profile_trace
from pyhgt_tpu_torch.train.optim import (
    FlatAdamW, ScheduledOptimizer, cosine_schedule, decays,
)
from pyhgt_tpu_torch.train.step import (
    TrainState, make_train_step, make_train_step_acc,
)

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
N_REQUESTS = 3
N_STEPS = 3
# kernel vs plain: both sum the same values in f32, in another order (the
# window kernel and the plain versions with atomics, whose order changes
# from run to run): 1e-4 absolute and relative, plus 1e-6 (17 f32 ulps) of
# the sum of the terms' magnitudes, which is what bounds a reordered f32 sum
# (a window row of the bench batch adds up to 26,624 rows)
KERNEL_TOL = 1e-4
SUM_TOL = 1e-6
# card (bf16 edge stage, kernels) vs CPU (plain path): per-edge tensors
# round to bf16 at 2^-8; sums run in another order on each side
CPU_TOL = 3e-2
# the same for a parameter's gradient, as max |GPU - CPU| over max |CPU|:
# a gradient sums many bf16-rounded per-edge products of mixed sign
GRAD_TOL = 3e-2


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.cache
def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


COUNTERS = (ps.live_partials, ps.live_partials_pair, ps.live_partials_slab,
            ps.live_partials_weighted, ps.segment_softmax_partials,
            ps.head_sum_product)
NO_LAUNCH = {"live_partials": 0, "pair_runs": 0, "pair_window": 0,
             "slab_runs": 0, "slab_window": 0, "weighted": 0, "softmax": 0,
             "head_sum": 0}


def reset_counts():
    for fn in COUNTERS:
        fn.launches = 0
    ps.live_partials_pair.window_launches = 0
    ps.live_partials_slab.window_launches = 0


def read_counts():
    pair, pair_w = (ps.live_partials_pair.launches,
                    ps.live_partials_pair.window_launches)
    slab, slab_w = (ps.live_partials_slab.launches,
                    ps.live_partials_slab.window_launches)
    return {"live_partials": ps.live_partials.launches,
            "pair_runs": pair - pair_w, "pair_window": pair_w,
            "slab_runs": slab - slab_w, "slab_window": slab_w,
            "weighted": ps.live_partials_weighted.launches,
            "softmax": ps.segment_softmax_partials.launches,
            "head_sum": ps.head_sum_product.launches}


def scaled(per_unit, n):
    """Expected counts: ``per_unit`` (kernels not named: 0) times ``n``."""
    return {k: per_unit.get(k, 0) * n for k in NO_LAUNCH}


# the softmax kernel built with -DSOFTMAX_PARTIALS_FLOOR=1 (its walk left
# out: the same launch, loads and stores) and =2 (a launch that returns at
# once), outputs meaningless; timed beside the kernel as the floors that its
# loads and stores, and its launch, set
FLOOR_LIBS = {level: cuda_build.BUILD_DIR
              / f"segment_softmax_partials_floor{level}.so" for level in (1, 2)}


def phase_build():
    t0 = time.perf_counter()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    floors = [subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
         f"-DSOFTMAX_PARTIALS_FLOOR={level}", "-o", str(path),
         str(cuda_build.CSRC / "segment_softmax_partials.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for level, path in FLOOR_LIBS.items()]
    # the host library (the C++ sampler and batch prep, g++) meanwhile
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native_build.build_library)
        paths = cuda_build.build(ps.KERNEL_SOURCES)
        for proc in floors:
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"softmax floor build failed:\n{out}")
        log(f"[build] {len(paths)} kernel source(s) in "
            f"{time.perf_counter() - t0:.2f} s")
        lib = host.result()
    log(f"[build] host C++ library {lib.name} (sampler + batch prep) ready "
        f"after {time.perf_counter() - t0:.2f} s")
    for name, text in cuda_build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def partials_bytes(data, aux: PallasSegAux, n_tensors=1):
    """Bytes the function must move: each data tensor, loc and blk read
    once, each output written once."""
    n_tiles = aux.loc.shape[0]
    out_rows = aux.num_blocks * aux.w
    return (n_tensors * data.numel() * data.element_size()
            + aux.loc.numel() * 4 + n_tiles * 4
            + n_tensors * out_rows * data.shape[1] * 4)


def bound_ms(data, aux, n_tensors=1):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the f32 additions (one per input value) over the f32
    rate. Returns (ms, bytes)."""
    nbytes = partials_bytes(data, aux, n_tensors)
    adds = n_tensors * data.numel()
    return max(nbytes / HBM_BYTES_PER_S, adds / F32_FLOPS) * 1e3, nbytes


def check_close(got, want, abs_sum, what):
    """``abs_sum``: the plain version's output for the data's magnitudes."""
    diff = (got - want).abs()
    err = diff.max().item()
    limit = KERNEL_TOL + KERNEL_TOL * want.abs() + SUM_TOL * abs_sum
    ok = bool((diff <= limit).all())
    log(f"[kernel] {what} -> {tuple(got.shape)}: max_abs_err {err:.3e} "
        f"(tol {KERNEL_TOL:g} + {KERNEL_TOL:g} x |value| + {SUM_TOL:g} x "
        f"sum|terms|; max |value| {want.abs().max().item():.1f}, max "
        f"sum|terms| {abs_sum.max().item():.0f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {what}")
    return err


def record(name, source, line, err, ms, plain_ms, bound, library_ms,
           bound_by="bytes", **extra):
    return {"name": name, "route": "cuda",
            "source": f"pyhgt_tpu_torch/csrc/{source}.cu",
            "replaces": f"pyhgt_tpu/ops/pallas_seg.py:{line}",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


def walk_outputs(gaux, D, n):
    """The allocation of a walk's ``n`` outputs, as one shape: the wrappers
    make them as views of one tensor."""
    return [(n, gaux.num_blocks * gaux.w, D)]


def check_walk(what, run, want, abs_sum, gaux, D):
    """A walk kernel's outputs (``run()``: a tensor or a pair) against its
    plain version's ``want`` (``abs_sum``: the plain version on the data's
    magnitudes). For a runs aux, which the kernel writes whole into
    uninitialised outputs, the outputs land on memory that held NaN: every
    row must come back written, the rows no edge reaches exactly 0, and a
    second call bit-identical. Returns the largest error."""
    want = want if isinstance(want, tuple) else (want,)
    abs_sum = abs_sum if isinstance(abs_sum, tuple) else (abs_sum,)
    shapes = walk_outputs(gaux, D, len(want))
    runs = not gaux.window

    def call():
        out = run()
        return out if isinstance(out, tuple) else (out,)
    got = on_nan_memory(call, shapes) if runs else call()
    err = 0.0
    for i, (g, w, a) in enumerate(zip(got, want, abs_sum)):
        err = max(err, check_close(g, w, a, f"{what}[{i}]"))
    if runs:
        again = on_nan_memory(call, shapes)
        reached = torch.zeros(shapes[0][1], dtype=torch.bool, device=g.device)
        rows = out_rows(gaux)
        reached[rows[rows >= 0]] = True
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        zero = not any(bool(g[~reached].any()) for g in got)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ok = same and zero and finite
        log(f"[kernel] {what}: on NaN-filled torch.empty memory every row "
            f"written {finite}, the {int((~reached).sum())} unreached rows "
            f"all 0 {zero}, second call bit-identical {same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what}: a row unwritten, an unreached row "
                                 "not 0, or two calls differ")
    return err


def time_walk(what, name, call, inputs, gaux, plain, library, library_name,
              nbytes, bound):
    """One walk kernel timed at one shape: its launch (``ps.walk_plan``),
    the eager wrapper (CUDA events over 20 calls: inputs warm in L2), the
    device time of ``COLD_COPIES`` calls on their own copies of the inputs
    in one CUDA graph (cold L2), the plain version and the library call.
    Prints the ``[time]`` line; returns the numbers."""
    plan = ps.walk_plan(name, inputs[0], gaux)
    ms = cuda_ms(lambda: call(*inputs))
    copies = [[t.clone() for t in inputs] for _ in range(COLD_COPIES)]
    cold_ms = graph_ms([lambda c=c: call(*c) for c in copies])
    del copies
    plain_ms = cuda_ms(lambda: plain(*inputs))
    library_ms = cuda_ms(library)
    log(f"[time] {what}: S={plan['split']}, grid ({plan['grid_x']}, "
        f"{plan['grid_y']}) x {plan['threads']} threads, "
        f"{plan['smem_bytes']} B shared, {plan['stage_rows']} rows a stage"
        f"{' copied row by row' if plan['row_by_row'] else ''}; kernel "
        f"{ms:.4f} ms eager ({nbytes / ms / 1e6:.1f} GB/s), {cold_ms:.4f} ms "
        f"device time in a CUDA graph of {COLD_COPIES} calls on their own "
        f"input copies (cold L2; {nbytes / cold_ms / 1e6:.1f} GB/s), plain "
        f"{plain_ms:.4f} ms, {library_name} {library_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s): "
        f"{bound / ms:.0%} of it eager, {bound / cold_ms:.0%} cold "
        f"| {card_line()}")
    return dict(ms=ms, graph_ms=cold_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound, **plan)


def walk_keys(t, prefix=""):
    """A timing's launch and cold time as record keys."""
    return {f"{prefix}graph_ms": t["graph_ms"], f"{prefix}split": t["split"],
            f"{prefix}grid": [t["grid_x"], t["grid_y"]],
            f"{prefix}threads": t["threads"]}


def phase_kernel(fl, dev, batch):
    """live_partials against its plain version at the main path's shapes,
    for the capped (bench) and legacy aux, bf16 and f32, on outputs whose
    memory held NaN; timed at the main path's configuration (bf16,
    capped)."""
    auxes = {
        "capped": fl.sort(batch, with_backward=False).pseg_tgt,
        "legacy": sort_batch(batch, fl.layout, fl.em,
                             with_backward=False).pseg_tgt,
    }
    cfg = fl.cfg
    if not (auxes["capped"].w == auxes["capped"].v == cfg.seg_rank_cap
            and auxes["legacy"].w == 384 and auxes["legacy"].v == 0):
        raise AssertionError("bench batch did not give the capped and "
                             "legacy aux widths")
    gen = torch.Generator(device=dev).manual_seed(0)
    E = auxes["capped"].loc.size
    base = torch.randn(E, cfg.n_hid, generator=gen, device=dev)
    max_err = 0.0
    timed = None
    for aux_name, aux in auxes.items():
        gaux = aux.to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = base.to(dtype)
            max_err = max(max_err, check_walk(
                f"live_partials {aux_name} W={aux.w} V={aux.v} "
                f"{str(dtype)[6:]} {tuple(x.shape)}",
                lambda: live_partials(x, gaux), live_partials_plain(x, gaux),
                live_partials_plain(x.abs(), gaux), gaux, x.shape[1]))
            if aux_name == "capped" and dtype == torch.bfloat16:
                timed = (x, gaux)

    x, gaux = timed
    rows = out_rows(gaux)
    x32 = x.float()
    zeros = torch.zeros(gaux.num_blocks * gaux.w, x.shape[1], device=dev)
    bound, nbytes = bound_ms(x, gaux)
    t = time_walk(f"live_partials bf16 {tuple(x.shape)} W=V={gaux.w}",
                  "live_partials", lambda a: live_partials(a, gaux), [x],
                  gaux, lambda a: live_partials_plain(a, gaux),
                  lambda: torch.index_add(zeros, 0, rows, x32),
                  "index_add (f32 source)", nbytes, bound)
    return record("live_partials", "live_partials", 759, max_err, t["ms"],
                  t["plain_ms"], bound, t["library_ms"], **walk_keys(t))


def split_aux(se):
    """The singleton-split aux of the bench batch's src grouping (degree-1
    sources become dead rows, loc = -1), at the smallest rank cap of 64, 128,
    384 that its tiles' multi-edge segments fit."""
    key = se.gidx.astype(np.int64)[se.perm_src]
    E, G = key.shape[0], se.seg_ptr_src.shape[0] - 1
    for cap in (64, 128, 384):
        split = pallas_seg_aux_split(key, G, K=se.pseg_src.loc.shape[1],
                                     W=cap, v=cap, single_cap=E)
        if split is not None:
            aux = split[0]
            dead = int((aux.loc < 0).sum())
            log(f"[kernel] singleton-split src aux: W = V = {cap}, {dead} "
                f"dead rows of {E}")
            if not (aux.dead_rows and dead):
                raise AssertionError("the split aux carries no dead row")
            return aux
    raise AssertionError("no singleton-split aux built for the bench batch")


def phase_pair_kernel(fl, dev, batch):
    """live_partials_pair against its plain version with the aux of a real
    sorted bench batch, bf16 and f32: the src runs aux (W = 384), the
    compacted tab-window aux (W = V = 64), the uncompacted one (no tab_cap:
    W = V = 240), the tab runs aux and the src singleton-split aux (dead
    rows), the runs aux on outputs whose memory held NaN. Timed in bf16 in
    the two cases the train step runs: src runs and compacted window."""
    se = fl.sort(batch)
    se_unc = sort_batch(batch, fl.layout, fl.em,
                        tgt_rank_cap=fl.cfg.seg_rank_cap)
    auxes = {
        "src-runs": se.pseg_src, "tab-window": se.ptab_src,
        "tab-window-uncompacted": se_unc.ptab_src, "tab-runs": se.pseg_tab,
    }
    shapes = {k: (a.w, a.v, a.window) for k, a in auxes.items()}
    auxes["src-singleton-split"] = split_aux(se)
    want_shapes = {
        "src-runs": (384, 0, False),
        "tab-window": (fl.cfg.tab_cap, fl.cfg.tab_cap, True),
        "tab-window-uncompacted": (240, 240, True),
        "tab-runs": (384, 0, False),
    }
    if shapes != want_shapes:
        raise AssertionError(f"bench batch gave aux {shapes}, expected "
                             f"{want_shapes}")
    gen = torch.Generator(device=dev).manual_seed(1)
    E = se.pseg_src.loc.size
    b1 = torch.randn(E, fl.cfg.n_hid, generator=gen, device=dev)
    b2 = torch.randn(E, fl.cfg.n_hid, generator=gen, device=dev)
    errs = {"runs": 0.0, "window": 0.0}
    timed = {}
    for name, aux in auxes.items():
        gaux = aux.to(dev)
        kind = "window" if aux.window else "runs"
        for dtype in (torch.bfloat16, torch.float32):
            d1, d2 = b1.to(dtype), b2.to(dtype)
            errs[kind] = max(errs[kind], check_walk(
                f"live_partials_pair {name} W={aux.w} V={aux.v} "
                f"{str(dtype)[6:]} {tuple(d1.shape)}",
                lambda: live_partials_pair(d1, d2, gaux),
                live_partials_pair_plain(d1, d2, gaux),
                live_partials_pair_plain(d1.abs(), d2.abs(), gaux), gaux,
                d1.shape[1]))
            if dtype == torch.bfloat16 and name in ("src-runs", "tab-window"):
                timed[kind] = (name, d1, d2, gaux)

    records = []
    for kind, (name, d1, d2, gaux) in timed.items():
        rows = out_rows(gaux)
        f1, f2 = d1.float(), d2.float()
        zeros = torch.zeros(gaux.num_blocks * gaux.w, d1.shape[1], device=dev)
        bound, nbytes = bound_ms(d1, gaux, n_tensors=2)
        t = time_walk(
            f"live_partials_pair {name} bf16 2 x {tuple(d1.shape)} "
            f"W={gaux.w} V={gaux.v} -> 2 x {tuple(zeros.shape)}",
            "live_partials_pair",
            lambda a, b: live_partials_pair(a, b, gaux), [d1, d2], gaux,
            lambda a, b: live_partials_pair_plain(a, b, gaux),
            lambda: (torch.index_add(zeros, 0, rows, f1),
                     torch.index_add(zeros, 0, rows, f2)),
            "two index_add (f32 sources)", nbytes, bound)
        records.append(record(
            f"live_partials_pair ({kind} aux: {name})", "live_partials_pair",
            275, errs[kind], t["ms"], t["plain_ms"], bound, t["library_ms"],
            kind=kind, **walk_keys(t)))
    return records


def time_line(what, ms, nbytes, plain_ms, library, library_ms, bound):
    log(f"[time] {what}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
        f"plain {plain_ms:.4f} ms, {library} {library_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s)")


def phase_slab_kernel(fl, dev, batch):
    """live_partials_slab against its plain version on the two aux the slab
    backward hands it (src runs, W = 384, on outputs whose memory held NaN;
    compacted tab window, W = V = 64), bf16 and f32 [E, 2 x 512] slabs;
    timed in bf16 on both."""
    se = fl.sort(batch)
    D = fl.cfg.n_hid
    gen = torch.Generator(device=dev).manual_seed(2)
    base = torch.randn(se.pseg_src.loc.size, 2 * D, generator=gen, device=dev)
    records = []
    for kind, name, aux in (("runs", "src-runs", se.pseg_src),
                            ("window", "tab-window", se.ptab_src)):
        gaux = aux.to(dev)
        err = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            x = base.to(dtype)
            err = max(err, check_walk(
                f"live_partials_slab {name} W={aux.w} V={aux.v} "
                f"{str(dtype)[6:]} {tuple(x.shape)}",
                lambda: ps.live_partials_slab(x, gaux),
                ps.live_partials_slab_plain(x, gaux),
                ps.live_partials_slab_plain(x.abs(), gaux), gaux, D))
        t = time_slab(f"live_partials_slab {name}", base.to(torch.bfloat16),
                      gaux)
        records.append(record(
            f"live_partials_slab ({kind} aux: {name})", "live_partials_slab",
            739, err, t["ms"], t["plain_ms"], t["bound_ms"], t["library_ms"],
            counter=f"slab_{kind}", launches_config='edge_bwd="slab"',
            **walk_keys(t)))
    return records


def time_slab(what, x, gaux):
    """live_partials_slab timed on the bf16 slab ``x [E, 2D]``."""
    D = x.shape[1] // 2
    rows = out_rows(gaux)
    f1, f2 = x[:, :D].float(), x[:, D:].float()
    zeros = torch.zeros(gaux.num_blocks * gaux.w, D, device=x.device)
    bound, nbytes = bound_ms(x[:, :D], gaux, n_tensors=2)
    return time_walk(
        f"{what} bf16 {tuple(x.shape)} W={gaux.w} V={gaux.v} -> 2 x "
        f"{tuple(zeros.shape)}", "live_partials_slab",
        lambda a: ps.live_partials_slab(a, gaux), [x], gaux,
        lambda a: ps.live_partials_slab_plain(a, gaux),
        lambda: (torch.index_add(zeros, 0, rows, f1),
                 torch.index_add(zeros, 0, rows, f2)),
        "two index_add (f32 halves)", nbytes, bound)


def phase_weighted_kernel(fl, dev, batch):
    """live_partials_weighted against its plain version on the capped and
    the legacy target aux and on the src singleton-split aux (dead rows: the
    walk's other instance), bf16 and f32 values; timed at the bench preset's
    configuration (bf16 values, capped aux)."""
    cfg = fl.cfg
    H, dk = cfg.n_heads, cfg.n_hid // cfg.n_heads
    auxes = {"capped": fl.sort(batch, with_backward=False).pseg_tgt,
             "legacy": sort_batch(batch, fl.layout, fl.em,
                                  with_backward=False).pseg_tgt,
             "src-singleton-split": split_aux(fl.sort(batch))}
    gen = torch.Generator(device=dev).manual_seed(3)
    E = auxes["capped"].loc.size
    w = torch.rand(E, H, generator=gen, device=dev)
    base = torch.randn(E, cfg.n_hid, generator=gen, device=dev)
    err, timed = 0.0, None
    for aux_name, aux in auxes.items():
        gaux = aux.to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            v = base.to(dtype)
            got = ps.live_partials_weighted(w, v, dk, gaux)
            want = ps.live_partials_weighted_plain(w, v, dk, gaux)
            abs_sum = ps.live_partials_weighted_plain(w, v.abs(), dk, gaux)
            torch.cuda.synchronize()
            err = max(err, check_close(
                got, want, abs_sum, f"live_partials_weighted {aux_name} "
                f"W={aux.w} V={aux.v} {str(dtype)[6:]} w {tuple(w.shape)} "
                f"v {tuple(v.shape)}"))
            if aux_name == "capped" and dtype == torch.bfloat16:
                timed = (v, gaux)
    v, gaux = timed
    rows = out_rows(gaux)
    msg32 = w.repeat_interleave(dk, dim=1) * v.float()
    zeros = torch.zeros(gaux.num_blocks * gaux.w, v.shape[1], device=dev)
    ms = cuda_ms(lambda: ps.live_partials_weighted(w, v, dk, gaux))
    plain_ms = cuda_ms(lambda: ps.live_partials_weighted_plain(w, v, dk, gaux))
    # no single PyTorch call forms the product and sums it: the yardstick is
    # the sum alone, index_add of the message tensor multiplied ahead
    library_ms = cuda_ms(lambda: torch.index_add(zeros, 0, rows, msg32))
    nbytes = partials_bytes(v, gaux) + w.numel() * 4
    bound = max(nbytes / HBM_BYTES_PER_S, 2 * v.numel() / F32_FLOPS) * 1e3
    time_line(f"live_partials_weighted bf16 v {tuple(v.shape)} w "
              f"{tuple(w.shape)} W=V={gaux.w}", ms, nbytes, plain_ms,
              "index_add of the ready f32 product", library_ms, bound)
    return record("live_partials_weighted", "live_partials_weighted", 622,
                  err, ms, plain_ms, bound, library_ms, counter="weighted",
                  launches_config="sorted_hgt.WEIGHTED_KERNEL = True")


def phase_head_sum_kernel(fl, dev):
    """head_sum_product against its plain version at the edge stage's shapes
    ([E, 512], 8 heads of 64 lanes), bf16 and f32; timed in bf16."""
    cfg = fl.cfg
    dk = cfg.n_hid // cfg.n_heads
    E = -(-fl.layout.num_edges // ps.PK) * ps.PK
    gen = torch.Generator(device=dev).manual_seed(4)
    a32 = torch.randn(E, cfg.n_hid, generator=gen, device=dev)
    b32 = torch.randn(E, cfg.n_hid, generator=gen, device=dev)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        a, b = a32.to(dtype), b32.to(dtype)
        got = ps.head_sum_product(a, b, dk)
        want = ps.head_sum_product_plain(a, b, dk)
        abs_sum = ps.head_sum_product_plain(a.abs(), b.abs(), dk)
        torch.cuda.synchronize()
        err = max(err, check_close(
            got, want, abs_sum, f"head_sum_product {str(dtype)[6:]} 2 x "
            f"{tuple(a.shape)} dk={dk}"))
    a, b = a32.to(torch.bfloat16), b32.to(torch.bfloat16)
    H = cfg.n_heads
    ms = cuda_ms(lambda: ps.head_sum_product(a, b, dk))
    plain_ms = cuda_ms(lambda: ps.head_sum_product_plain(a, b, dk))
    library_ms = cuda_ms(lambda: (a.float() * b).view(E, H, dk).sum(-1))
    nbytes = 2 * a.numel() * a.element_size() + E * H * 4
    bound = max(nbytes / HBM_BYTES_PER_S, 2 * a.numel() / F32_FLOPS) * 1e3
    time_line(f"head_sum_product bf16 2 x {tuple(a.shape)} -> ({E}, {H})", ms,
              nbytes, plain_ms, "(a.float() * b).view(E, H, dk).sum(-1)",
              library_ms, bound)
    return record("head_sum_product", "head_sum_product", 515, err, ms,
                  plain_ms, bound, library_ms, counter="head_sum",
                  launches_config="one standalone call: no path of the "
                  "package calls this function")


def graph_ms(fns, replays=20):
    """Device time per call of the ``fns``, captured in turn into one CUDA
    graph and replayed ``replays`` times between CUDA events: no Python or
    launch gaps of the host between the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up off the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn in fns]
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del outs
    return start.elapsed_time(end) / (replays * len(fns))


# copies of the logits a cold timing cycles through: 8 x 7.25 MB at bench
# shapes, more than the card's 50 MB L2, so each call reads from memory
COLD_COPIES = 8


def poisoned_softmax(att, gaux):
    """The softmax wrapper on memory that held NaN: two NaN tensors of the
    outputs' size are made and freed just before, so the caching allocator
    hands that memory to the wrapper's torch.empty."""
    shape = (gaux.num_blocks * gaux.w, att.shape[1])
    bait = [torch.full(shape, float("nan"), device=att.device)
            for _ in range(2)]
    ptrs = [b.data_ptr() for b in bait]
    del bait
    m, s = ps.segment_softmax_partials(att, gaux)
    if [m.data_ptr(), s.data_ptr()] != ptrs:
        raise AssertionError("the softmax outputs did not land on NaN memory")
    return m, s


def phase_softmax_kernel(fl, dev, batch):
    """segment_softmax_partials against its plain version on the legacy
    target aux of the bench batch, logits [E, 8] f32 with the batch's masked
    rows at -1e30, on outputs whose memory held NaN. The emitted max (the
    bf16 rounding of each slice's max) must be bit-equal; the sums add the
    same f32 exps in another order, with ex2.approx against torch.exp: 1e-5
    relative. The tail rows no slice reaches must be exactly 0. Timed as a
    device time (``COLD_COPIES`` calls on their own copies of the logits in
    one CUDA graph: cold L2, no host gaps), beside the same launch without
    its walk and returning at once, and as the eager wrapper."""
    se = sort_batch(batch, fl.layout, fl.em, with_backward=False)
    aux = se.pseg_tgt
    if aux.v or aux.w != ps.PK or aux.live_key is None:
        raise AssertionError("expected the legacy target aux")
    gaux = aux.to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    H = fl.cfg.n_heads
    att = torch.randn(aux.loc.size, H, generator=gen, device=dev) * 4
    mask = torch.as_tensor(se.edge_mask, device=dev)
    att = torch.where(mask[:, None], att, torch.full_like(att, -1e30))
    m, s = poisoned_softmax(att, gaux)
    pm, psum = ps.segment_softmax_partials_plain(att, gaux)
    torch.cuda.synchronize()
    m_equal = bool(torch.equal(m, pm))
    diff = (s - psum).abs()
    err = diff.max().item()
    ok = m_equal and bool((diff <= 1e-5 * psum.abs()).all())
    n_tiles, K = aux.loc.shape
    live = int(aux.blk[n_tiles - 1]) * aux.w + int(aux.loc[-1, -1]) + 1
    tail_zero = not (m[live:].any() or s[live:].any())
    m2, s2 = poisoned_softmax(att, gaux)
    same_bits = bool(torch.equal(m2, m) and torch.equal(s2, s))
    log(f"[kernel] segment_softmax_partials legacy W={aux.w} att "
        f"{tuple(att.shape)} ({int((~mask).sum())} masked rows) -> 2 x "
        f"{tuple(m.shape)} on NaN-filled torch.empty memory: max bit-equal "
        f"{m_equal}, sums max_abs_err {err:.3e} (tol 1e-5 x |value|, max "
        f"|value| {psum.max().item():.1f}), tail rows [{live}, {m.shape[0]}) "
        f"all 0 {tail_zero}, second call bit-identical {same_bits} "
        f"{'ok' if ok else 'FAIL'}")
    if not (ok and tail_zero and same_bits and live < m.shape[0]
            and bool(torch.isfinite(m).all())):
        raise AssertionError("segment_softmax_partials disagrees with its "
                             "plain version")
    lib = cuda_build.load("segment_softmax_partials")
    window = gaux.w + (gaux.v or K)
    lib.segment_softmax_partials_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    blocks = lib.segment_softmax_partials_blocks_per_sm(K, H, window)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = -(-n_tiles // (blocks * sms)) if blocks > 0 else 0
    log(f"[kernel] segment_softmax_partials: 256 threads and "
        f"{ps._softmax_smem_bytes(K, H, window)} bytes of shared memory a "
        f"block, {blocks} blocks resident per SM x {sms} SMs for {n_tiles} "
        f"tiles: {waves} wave(s)")

    rows = out_rows(gaux)
    idx = rows[:, None].expand(-1, H)
    copies = [att.clone() for _ in range(COLD_COPIES)]
    exps = [torch.exp(torch.clamp(a - pm[rows], max=80.0)) for a in copies]
    zeros = torch.zeros_like(pm)

    def library(a, ex):
        return (torch.scatter_reduce(zeros, 0, idx, a, "amax",
                                     include_self=False),
                torch.index_add(zeros, 0, rows, ex))

    ms = graph_ms([lambda a=a: ps.segment_softmax_partials(a, gaux)
                   for a in copies])
    # no single PyTorch call: the yardstick is the two reductions alone, a
    # scatter-max of the logits and an index_add of exps computed ahead
    library_ms = graph_ms([lambda a=a, ex=ex: library(a, ex)
                           for a, ex in zip(copies, exps)])
    n_out = gaux.num_blocks * gaux.w

    def floor_ms(level, inputs=copies):
        fn = ctypes.CDLL(str(FLOOR_LIBS[level])).segment_softmax_partials_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_longlong, ctypes.c_void_p]

        def floor(a):
            fm, fs = torch.empty_like(m), torch.empty_like(s)
            if fn(a.data_ptr(), gaux.loc.data_ptr(), gaux.blk.data_ptr(),
                  fm.data_ptr(), fs.data_ptr(), n_tiles, K, H, gaux.w, window,
                  n_out, torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("softmax floor launch failed")
            return fm, fs
        return graph_ms([lambda a=a: floor(a) for a in inputs])

    load_floor_ms, launch_floor_ms = floor_ms(1), floor_ms(2)
    # the same with one copy 8 times: the logits stay in L2
    warm = [att] * COLD_COPIES
    warm_ms = graph_ms([lambda a=a: ps.segment_softmax_partials(a, gaux)
                        for a in warm])
    load_floor_warm_ms = floor_ms(1, warm)
    wrapper_ms = cuda_ms(lambda: ps.segment_softmax_partials(att, gaux))
    library_eager_ms = cuda_ms(lambda: library(att, exps[0]))
    plain_ms = cuda_ms(lambda: ps.segment_softmax_partials_plain(att, gaux))
    nbytes = (att.numel() * 4 + aux.loc.size * 4 + aux.loc.shape[0] * 4
              + 2 * m.numel() * 4)
    # per logit: a max, a subtraction, a min, an exp, an addition
    bound = max(nbytes / HBM_BYTES_PER_S, 5 * att.numel() / F32_FLOPS) * 1e3
    log(f"[time] segment_softmax_partials att {tuple(att.shape)} W={aux.w}: "
        f"kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s; {COLD_COPIES} "
        f"calls on their own copies in one CUDA graph, cold L2; the same "
        f"launch without its walk {load_floor_ms:.4f} ms, returning at once "
        f"{launch_floor_ms:.4f} ms; with warm L2 {warm_ms:.4f} ms, without "
        f"its walk {load_floor_warm_ms:.4f} ms), eager "
        f"wrapper {wrapper_ms:.4f} ms (warm L2, host launch), plain "
        f"{plain_ms:.4f} ms, scatter_reduce(amax) + index_add of ready exps "
        f"{library_ms:.4f} ms in the graph ({library_eager_ms:.4f} ms "
        f"eager), bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s) "
        f"| {card_line()}")
    return record("segment_softmax_partials", "segment_softmax_partials",
                  423, err, ms, plain_ms, bound, library_ms,
                  counter="softmax",
                  launches_config="seg_rank_cap=0, softmax_pallas=True",
                  wrapper_ms=wrapper_ms, library_eager_ms=library_eager_ms,
                  load_floor_ms=load_floor_ms,
                  launch_floor_ms=launch_floor_ms, warm_l2_ms=warm_ms,
                  load_floor_warm_l2_ms=load_floor_warm_ms,
                  timing="ms, library_ms and the floors: CUDA graph of 8 "
                         "calls on 8 copies of the logits, cold L2 (*warm_l2*: "
                         "one copy 8 times); wrapper_ms, library_eager_ms and "
                         "plain_ms: 20 eager calls",
                  blocks_per_sm=blocks)


def phase_head_sum_path(fl, dev, batch):
    """The one way head_sum_product is reached: a caller's own call. One
    layer's attention logits from gathered bf16 rows, against the edge
    stage's ``_head_sum_prod`` on the same rows."""
    cfg = fl.cfg
    H, dk = cfg.n_heads, cfg.n_hid // cfg.n_heads
    se = fl.sort(batch, with_backward=False).to(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    N = fl.layout.num_types * cfg.node_cap
    G = len(fl.layout.blocks) * cfg.node_cap
    q_n = torch.randn(N, cfg.n_hid, generator=gen, device=dev).bfloat16()
    k_rel = torch.randn(G, cfg.n_hid, generator=gen, device=dev).bfloat16()
    q_e, k_e = q_n[se.edge_tgt], k_rel[se.gidx]
    reset_counts()
    pre = ps.head_sum_product(q_e, k_e, dk)
    counts = read_counts()
    want = sorted_hgt._head_sum_prod(q_e, k_e, H, dk)
    torch.cuda.synchronize()
    err = (pre - want).abs().max().item()
    log(f"[headsum] head_sum_product on gathered rows {tuple(q_e.shape)}: "
        f"max |kernel - _head_sum_prod| {err:.3e} (tol {KERNEL_TOL:g} + "
        f"{KERNEL_TOL:g} x |value|), launches {counts['head_sum']}")
    if not bool(((pre - want).abs() <= KERNEL_TOL
                 + KERNEL_TOL * want.abs()).all()):
        raise AssertionError("head_sum_product disagrees with _head_sum_prod")
    if counts != scaled({"head_sum": 1}, 1):
        raise AssertionError(f"launches {counts}")
    return counts


def answer(fl, seed):
    """One request: synthetic batch -> host sort -> forward -> argmax."""
    t0 = time.perf_counter()
    batch, _ = synth_flagship_batch(fl, seed=seed)
    t1 = time.perf_counter()
    se = fl.sort(batch, with_backward=False)
    t2 = time.perf_counter()
    logp = fl.forward(batch, se)
    pred = logp.argmax(dim=-1).cpu()
    t3 = time.perf_counter()
    return logp, pred, {"synth_ms": (t1 - t0) * 1e3,
                        "sort_ms": (t2 - t1) * 1e3,
                        "forward_ms": (t3 - t2) * 1e3}


def phase_requests(fl, n_edges):
    cfg = fl.cfg
    answer(fl, seed=100)                    # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    reset_counts()
    results = [answer(fl, seed=i) for i in range(N_REQUESTS)]
    counts = read_counts()
    for i, (logp, pred, t) in enumerate(results):
        lse = torch.logsumexp(logp.float(), dim=-1)
        finite = bool(torch.isfinite(logp).all())
        lse_err = lse.abs().max().item()
        log(f"[serve] request {i}: log-probs {tuple(logp.shape)} finite="
            f"{finite} max|logsumexp| {lse_err:.2e} pred[:8] "
            f"{pred[:8].tolist()} | sort {t['sort_ms']:.1f} ms, forward "
            f"{t['forward_ms']:.2f} ms")
        if logp.shape != (cfg.n_seed, cfg.n_classes) or not finite:
            raise AssertionError(f"request {i}: bad log-probs")
        if lse_err > 1e-3:
            raise AssertionError(f"request {i}: rows do not normalize")
    fwd = float(np.mean([t["forward_ms"] for _, _, t in results]))
    srt = float(np.mean([t["sort_ms"] for _, _, t in results]))
    syn = float(np.mean([t["synth_ms"] for _, _, t in results]))
    log(f"[serve] {N_REQUESTS} requests: {srt + fwd:.2f} ms/request = host "
        f"sort {srt:.2f} ms + forward {fwd:.2f} ms (batch synthesis, the "
        f"sampler's stand-in, {syn:.1f} ms more); {n_edges} edges/request -> "
        f"{n_edges / (fwd / 1e3):.6g} edges/s (forward), "
        f"{n_edges / ((srt + fwd) / 1e3):.6g} edges/s (sort + forward); "
        f"these count each edge once per forward")
    expected = scaled({"live_partials": cfg.n_layers}, N_REQUESTS)
    log(f"[serve] kernel launches {counts} (expected live_partials = "
        f"n_layers x requests and no other launch)")
    if counts != expected:
        raise AssertionError("the serving path did not run the kernel once "
                             "per layer")
    return results[0][0], counts


def phase_cpu(logp_gpu):
    fl_cpu = build_flagship("bench", device="cpu", seed=0)
    t0 = time.perf_counter()
    logp_cpu, _, _ = answer(fl_cpu, seed=0)
    err = (logp_gpu.cpu() - logp_cpu).abs().max().item()
    ok = err <= CPU_TOL
    log(f"[cpu] request 0 on the CPU plain path in "
        f"{time.perf_counter() - t0:.1f} s: max |GPU - CPU| log-prob "
        f"{err:.3e} (tol {CPU_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("GPU and CPU forwards disagree")


# launches per train step (``step``) and per serving forward (``serve``) of
# the main path and of configurations (A)-(C), per layer (kernels not
# named: none)
MAIN_STEP = {"live_partials": 2, "pair_runs": 1, "pair_window": 1}
MAIN_SERVE = {"live_partials": 1}
CONFIGS = {
    # (A) the lane-concatenated backward: one [E, 2D] permute, the slab
    # kernel on the src runs aux and on the tab-window aux, no pair
    "A": dict(overrides=dict(edge_bwd="slab"), weighted=False,
              step={"live_partials": 2, "slab_runs": 1, "slab_window": 1},
              # the slab kernel belongs to the backward: a forward runs none
              serve=MAIN_SERVE),
    # (B) the weighted kernel for the forward aggregation and g_q_n
    "B": dict(overrides={}, weighted=True,
              step={"weighted": 2, "pair_runs": 1, "pair_window": 1},
              serve={"weighted": 1}),
    # (C) the softmax kernel; it needs the legacy target aux, so no rank cap
    "C": dict(overrides=dict(seg_rank_cap=0, softmax_pallas=True),
              weighted=False, step=dict(MAIN_STEP, softmax=1),
              serve=dict(MAIN_SERVE, softmax=1)),
}


class weighted_kernel:
    """``sorted_hgt.WEIGHTED_KERNEL`` set for a block, restored after."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.old = sorted_hgt.WEIGHTED_KERNEL
        sorted_hgt.WEIGHTED_KERNEL = self.on

    def __exit__(self, *exc):
        sorted_hgt.WEIGHTED_KERNEL = self.old


def phase_train(dev, batch, labels, n_edges, tag="train", overrides=None,
                weighted=False, step_counts=MAIN_STEP):
    """The trainer's path under one configuration: a fresh seeded flagship,
    the bench's optimizer, one warm-up step and N_STEPS timed steps on one
    batch, the launches of every kernel counted from 0 after the warm-up and
    held to ``step_counts`` (per layer and step)."""
    fl = build_flagship("bench", device=dev, seed=0, **(overrides or {}))
    cfg = fl.cfg
    t0 = time.perf_counter()
    se = fl.sort(batch)
    sort_ms = (time.perf_counter() - t0) * 1e3
    args = fl.to_device(batch, se, labels)
    state, step = make_flagship_trainer(fl)
    before = {n: p.detach().clone() for n, p in fl.model.named_parameters()}
    with weighted_kernel(weighted):
        warm = float(step(*args))            # warm-up (cuBLAS, allocator)
        torch.cuda.synchronize()
        reset_counts()
        losses, times = [], []
        for _ in range(N_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(*args)))    # reading the loss waits
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
    log(f"[{tag}] configuration {overrides or {}}"
        f"{' WEIGHTED_KERNEL' if weighted else ''}: host sort with the "
        f"backward's aux {sort_ms:.1f} ms (once); warm-up loss {warm:.4f}")
    for i, (loss, ms) in enumerate(zip(losses, times)):
        log(f"[{tag}] step {i}: loss {loss:.4f}, {ms:.2f} ms")
    if not all(np.isfinite(losses + [warm])):
        raise AssertionError("a training loss is not finite")
    bad = [n for n, p in fl.model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if bad:
        raise AssertionError(f"parameters without a finite gradient: {bad}")
    still = [n for n, p in fl.model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"parameters that did not move: {still}")
    if state.step != N_STEPS + 1:
        raise AssertionError(f"optimizer count {state.step}")
    ms = float(np.mean(times))
    log(f"[{tag}] {N_STEPS} steps: {ms:.2f} ms/step (forward with dropout + "
        f"backward + clip + AdamW, batch resident on the card); {n_edges} "
        f"valid edges x {cfg.n_layers} layers / step time -> "
        f"{n_edges * cfg.n_layers / (ms / 1e3):.6g} train edges/s (counts "
        f"each edge once per layer; the [serve] edges/s counts each edge "
        f"once per forward)")
    expected = scaled(step_counts, cfg.n_layers * N_STEPS)
    per_step = {k: v / N_STEPS for k, v in counts.items() if v}
    log(f"[{tag}] kernel launches per step {per_step} (expected per layer "
        f"{step_counts}, x {cfg.n_layers} layers)")
    if counts != expected:
        raise AssertionError(f"[{tag}] the train step's launches {counts} != "
                             f"{expected}")
    return counts, ms


def phase_serve_config(dev, name):
    """One served request under configuration (A), (B) or (C), every
    kernel's launches counted from 0 just before it and held to the
    configuration's ``serve`` counts (per layer)."""
    cfg = CONFIGS[name]
    fl = build_flagship("bench", device=dev, seed=0, **cfg["overrides"])
    with weighted_kernel(cfg["weighted"]):
        answer(fl, seed=100)
        torch.cuda.synchronize()
        reset_counts()
        logp, _, t = answer(fl, seed=0)
        counts = read_counts()
    tag = f"serve-{name}"
    finite = bool(torch.isfinite(logp).all())
    lse_err = torch.logsumexp(logp.float(), dim=-1).abs().max().item()
    log(f"[{tag}] one request under {cfg['overrides'] or {}}"
        f"{' WEIGHTED_KERNEL' if cfg['weighted'] else ''}: log-probs "
        f"{tuple(logp.shape)} finite={finite} max|logsumexp| {lse_err:.2e}, "
        f"forward {t['forward_ms']:.2f} ms, launches "
        f"{ {k: v for k, v in counts.items() if v} } (expected per layer "
        f"{cfg['serve']}, x {fl.cfg.n_layers} layers)")
    if logp.shape != (fl.cfg.n_seed, fl.cfg.n_classes) or not finite \
            or lse_err > 1e-3:
        raise AssertionError(f"[{tag}] bad log-probs")
    if counts != scaled(cfg["serve"], fl.cfg.n_layers):
        raise AssertionError(f"[{tag}] launches {counts}")
    return counts


def loss_and_grads(dev, batch, labels, weighted=False, **overrides):
    fl = build_flagship("bench", device=dev, seed=0, dropout=0.0, **overrides)
    with weighted_kernel(weighted):
        loss = fl.loss(batch, fl.sort(batch), labels)
        loss.backward()
    return loss.item(), {n: p.grad.detach().float().cpu()
                         for n, p in fl.model.named_parameters()}


def compare_grads(tag, what, got, ref, t0=None):
    """Loss and every parameter gradient of ``got`` against ``ref``: the
    loss to CPU_TOL, each gradient to GRAD_TOL of the reference's scale."""
    (loss_g, grads_g), (loss_r, grads_r) = got, ref
    worst, worst_name = 0.0, ""
    for name, gr in grads_r.items():
        rel = ((grads_g[name] - gr).abs().max() / gr.abs().max()).item()
        if not rel <= worst:                 # a NaN is the worst there is
            worst, worst_name = rel, name
    loss_err = abs(loss_g - loss_r)
    ok = worst <= GRAD_TOL and loss_err <= CPU_TOL
    took = "" if t0 is None else f"; {time.perf_counter() - t0:.1f} s"
    log(f"[{tag}] {what}: loss {loss_g:.5f} against {loss_r:.5f} (|diff| "
        f"{loss_err:.2e}, tol {CPU_TOL:g}); {len(grads_r)} parameter "
        f"gradients, worst max|diff| / max|reference| {worst:.3e} at "
        f"{worst_name} (tol {GRAD_TOL:g}){took} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] gradients disagree: {what}")


def phase_grads(dev, batch, labels):
    """One loss-and-gradient, dropout off, on the card (kernels) and on the
    CPU (plain path), from the same seeded weights. Returns the card's."""
    on_card = loss_and_grads(dev, batch, labels)
    t0 = time.perf_counter()
    on_cpu = loss_and_grads("cpu", batch, labels)
    compare_grads("grads", "main path, GPU against the CPU plain path",
                  on_card, on_cpu, t0)
    return on_card


# routes that launch no kernel the main path and (A)-(C) do not: three
# steps each with their launches per layer asserted, and their gradients
# held against the main path's on the card only
CARD_ONLY = {
    # both groupings rebuilt in their own order: the pair twice on a runs aux
    "recompute": dict(overrides=dict(edge_bwd="recompute"),
                      step={"live_partials": 2, "pair_runs": 2}),
    "src_direct": dict(overrides=dict(edge_bwd="src_direct"), step=MAIN_STEP),
    # the guarded tilemax softmax: the spread flag is read on the host, one
    # wait for the device per layer
    "tilemax-auto": dict(overrides=dict(softmax_tilemax="auto"),
                         step=MAIN_STEP),
}


def phase_config_grads(dev, batch, labels, main):
    """Loss and gradients, dropout off, of configurations (A)-(C) and of the
    other backward strategies on the card against the main path's on the
    card (same batch, same weights: the routes differ in where values round
    to bf16 and in summation order), and of (A)-(C) against the same
    configuration on the CPU's plain path."""
    for name, cfg in CONFIGS.items():
        got = loss_and_grads(dev, batch, labels, cfg["weighted"],
                             **cfg["overrides"])
        compare_grads(f"grads-{name}", "GPU against the main path on the GPU",
                      got, main)
        t0 = time.perf_counter()
        on_cpu = loss_and_grads("cpu", batch, labels, cfg["weighted"],
                                **cfg["overrides"])
        compare_grads(f"grads-{name}", "GPU against the CPU plain path", got,
                      on_cpu, t0)
    for name, cfg in CARD_ONLY.items():
        t0 = time.perf_counter()
        got = loss_and_grads(dev, batch, labels, **cfg["overrides"])
        compare_grads(f"grads-{name}", "GPU against the main path on the GPU",
                      got, main, t0)


# ------------------------------------------------- the training-step extras
# remat runs the forward's kernels again in the backward's recompute: per
# layer and step one more live_partials (the forward aggregation) and,
# where the path runs it, one more segment_softmax_partials; the pair
# belongs to the backward alone
REMAT_STEP = dict(MAIN_STEP, live_partials=3)
# fused AdamW against the per-tensor AdamW on the same gradients: the bound
# the CPU tests hold the port's fused optimizer to against the JAX package's
FUSED_RTOL, FUSED_ATOL = 1e-5, 1e-6
# param_bf16 against the f32 step: the loss as the JAX package's own test
# holds it (rtol 2e-2); every gradient as the bf16 edge stage's against the
# CPU (GRAD_TOL): bf16 weight banks move the activations by 2^-9 of their
# size and the banks' gradients round to bf16
BF16_LOSS_TOL = 2e-2
# remat (and the accumulated step) against the plain step on the card: the
# card's run-to-run spread of a gradient (the window kernel adds with
# atomics; [determinism] read 1.6e-3 and 2.5e-3 of scale), with margin
SPREAD_TOL = 5e-3


def bench_state(dev, fused=False, **overrides):
    """A fresh seeded bench-preset flagship and the bench's trainer."""
    fl = build_flagship("bench", device=dev, seed=0, **overrides)
    state, step = make_flagship_trainer(fl, fused)
    return fl, state, step


def timed_steps(step, args, n=N_STEPS):
    """ms per call of ``step(*args)`` over ``n`` calls, each read to the
    host (the read waits for the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        float(step(*args))
    return (time.perf_counter() - t0) * 1e3 / n


def phase_fused_opt(dev, batch, labels):
    """[fused-opt]: the flattened-vector AdamW (``fused_opt``) against the
    default per-tensor AdamW at the bench preset: the parameters after
    N_STEPS updates from the same gradients (each step's backward on the
    default model, its gradients copied to the fused one); ms per train
    step of both (in turns); ms of ``optimizer.step()`` alone (clip and
    update) for both and for the library's ``AdamW(fused=True)`` under
    the same clip (timed only, used on no path). Returns the launches of
    the timed steps."""
    fa, sa, step_a = bench_state(dev)
    fb, sb, step_b = bench_state(dev, fused=True)
    if not isinstance(sb.optimizer.inner, FlatAdamW):
        raise AssertionError("[fused-opt] fused_opt did not select FlatAdamW")
    args = fa.to_device(batch, fa.sort(batch), labels)
    pa, pb = dict(fa.model.named_parameters()), dict(fb.model.named_parameters())
    for _ in range(N_STEPS):
        sa.optimizer.zero_grad()
        sb.optimizer.zero_grad()
        fa.loss(*args).backward()
        for n, p in pa.items():
            pb[n].grad = p.grad.detach().clone()
        sa.optimizer.step()
        sb.optimizer.step()
    worst, worst_name = 0.0, ""
    for n, p in pa.items():
        excess = ((pb[n] - p).abs() / (FUSED_ATOL + FUSED_RTOL * p.abs())
                  ).max().item()
        if not excess <= worst:
            worst, worst_name = excess, n
    ok = worst <= 1.0
    log(f"[fused-opt] {len(pa)} parameters after {N_STEPS} updates from the "
        f"same gradients, fused against default: worst |diff| / (atol "
        f"{FUSED_ATOL:g} + rtol {FUSED_RTOL:g} x |default|) {worst:.3f} at "
        f"{worst_name} (<= 1) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[fused-opt] the fused AdamW disagrees")
    float(step_a(*args))
    float(step_b(*args))
    reset_counts()
    ms = {"default": [], "fused": []}
    for name, step in (("default", step_a), ("fused", step_b),
                       ("fused", step_b), ("default", step_a)):
        ms[name].append(timed_steps(step, args))
    counts = read_counts()
    want = scaled(MAIN_STEP, fa.cfg.n_layers * 4 * N_STEPS)
    log(f"[fused-opt] train step ({N_STEPS} steps x 2 turns each, in turns "
        f"default, fused, fused, default): default {np.mean(ms['default']):.2f}"
        f" ms ({ms['default'][0]:.2f}, {ms['default'][1]:.2f}), fused "
        f"{np.mean(ms['fused']):.2f} ms ({ms['fused'][0]:.2f}, "
        f"{ms['fused'][1]:.2f}); launches {counts} (expected {want}) "
        f"{'ok' if counts == want else 'FAIL'} | {card_line()}")
    if counts != want:
        raise AssertionError(f"[fused-opt] launches {counts}")
    # optimizer.step() alone on the gradients of the last step
    named = list(fa.model.named_parameters())
    lib = ScheduledOptimizer(torch.optim.AdamW(
        [{"params": [p for n, p in named if decays(n)], "weight_decay": 0.01},
         {"params": [p for n, p in named if not decays(n)],
          "weight_decay": 0.0}], lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
        fused=True), cosine_schedule(1e-3, 1000), 0.25)
    n_params = sum(p.numel() for p in pa.values())
    opt_ms = {"default": [], "fused": [], "library": []}
    for name, opt in (("default", sa.optimizer), ("fused", sb.optimizer),
                      ("library", lib), ("library", lib),
                      ("fused", sb.optimizer), ("default", sa.optimizer)):
        opt_ms[name].append(cuda_ms(opt.step))
    # each update reads the gradient, parameter and two moments and writes
    # the parameter and two moments: 7 f32 passes over the parameters
    bound = 7 * 4 * n_params / HBM_BYTES_PER_S * 1e3
    log(f"[fused-opt] optimizer.step() alone (global-norm clip 0.25 + AdamW "
        f"over {n_params:,} f32 parameters in {len(pa)} tensors, 20 calls "
        f"after 3, twice each in turns): default (per-tensor foreach) "
        f"{np.mean(opt_ms['default']):.3f} ms, fused (one flat vector) "
        f"{np.mean(opt_ms['fused']):.3f} ms, library AdamW(fused=True) "
        f"{np.mean(opt_ms['library']):.3f} ms; bound {bound:.3f} ms (7 f32 "
        f"passes over the parameters at {HBM_BYTES_PER_S / 1e12:.2f} TB/s) | "
        f"{card_line()}")
    return counts


@contextlib.contextmanager
def kernel_dtypes():
    """The dtypes each kernel of the sorted edge stage receives while the
    block runs: ``{kernel: {dtype, ...}}``."""
    seen = {}
    names = ("live_partials", "live_partials_pair", "live_partials_slab",
             "live_partials_weighted", "segment_softmax_partials")
    orig = {n: getattr(sorted_hgt, n) for n in names}

    def spy(name):
        def call(*args, **kw):
            seen.setdefault(name, set()).add(str(args[0].dtype))
            return orig[name](*args, **kw)
        return call

    for n in names:
        setattr(sorted_hgt, n, spy(n))
    try:
        yield seen
    finally:
        for n, fn in orig.items():
            setattr(sorted_hgt, n, fn)


def grads_of(dev, batch, labels, **overrides):
    """Loss, gradients (f32 on the host) and the gradients' dtypes of one
    bench-preset forward and backward, dropout 0."""
    fl = build_flagship("bench", device=dev, seed=0, dropout=0.0, **overrides)
    loss = fl.loss(batch, fl.sort(batch), labels)
    loss.backward()
    named = list(fl.model.named_parameters())
    return (loss.item(), {n: p.grad.detach().float().cpu() for n, p in named},
            {str(p.grad.dtype) for _, p in named})


def steps_and_peak(tag, dev, batch, labels, step_counts, fused=False,
                   **overrides):
    """One warm-up step, then N_STEPS timed steps of a fresh bench-preset
    trainer under ``overrides``, their peak memory and their launches
    (held to ``step_counts`` per layer)."""
    fl, state, step = bench_state(dev, fused, **overrides)
    args = fl.to_device(batch, fl.sort(batch), labels)
    float(step(*args))
    _sync(dev)
    _reset_peak(dev)
    reset_counts()
    ms = timed_steps(step, args)
    counts = read_counts()
    peak = _peak_gib(dev)
    want = scaled(step_counts, fl.cfg.n_layers * N_STEPS)
    log(f"[{tag}] {overrides}: {ms:.2f} ms/step ({N_STEPS} steps), peak "
        f"{peak:.3f} GiB; launches per step "
        f"{ {k: v / N_STEPS for k, v in counts.items() if v} } (expected per "
        f"layer {step_counts}) {'ok' if counts == want else 'FAIL'}")
    if counts != want:
        raise AssertionError(f"[{tag}] launches {counts} != {want}")
    del fl, state, step, args
    torch.cuda.empty_cache()
    return counts, ms, peak


def phase_param_bf16(dev, batch, labels):
    """[param-bf16]: the bench preset's loss and gradients with bf16 weight
    banks (``param_bf16``) against the f32 step (dropout 0), every gradient
    f32; the dtype each kernel receives; ms per step, peak memory and
    launches of both. Returns the launches of the timed steps."""
    loss32, g32, _ = grads_of(dev, batch, labels)
    with kernel_dtypes() as seen:
        loss16, g16, dtypes = grads_of(dev, batch, labels, param_bf16=True)
    rel = abs(loss16 - loss32) / abs(loss32)
    err = grads_err(g16, g32)
    ok = rel <= BF16_LOSS_TOL and err <= GRAD_TOL and dtypes == {
        "torch.float32"}
    log(f"[param-bf16] bench preset, dropout 0: loss {loss16:.5f} against the "
        f"f32 step's {loss32:.5f} (rel {rel:.2e}, tol {BF16_LOSS_TOL:g}); "
        f"{len(g32)} gradients, dtypes {sorted(dtypes)}, max err "
        f"{err:.3e} of the f32 gradient's scale (tol {GRAD_TOL:g}); kernels "
        f"received { {k: sorted(v) for k, v in seen.items()} } "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[param-bf16] the bf16 weight banks disagree")
    counts = dict(NO_LAUNCH)
    for pb in (False, True):
        c, _, _ = steps_and_peak("param-bf16", dev, batch, labels, MAIN_STEP,
                                 param_bf16=pb)
        if pb:
            counts = c
    log(f"[param-bf16] | {card_line()}")
    return counts


def ogbn_remat_steps(dev, graph):
    """One forward and backward of an ``[ogbn]`` path item at the
    ``ogbn_mag`` preset (D 512, the softmax kernel on) without and with
    ``remat`` (dropout 0, the same weights): gradients, launches and peak
    memory. Returns the launches under ``remat``."""
    item, layout, cfg = ogbn_item(graph)
    sampler = make_sampler(cfg, graph, log=lambda msg: None)
    task = OgbnNodeTask(graph=graph, sampler=sampler, layout=layout,
                        batch_size=cfg.batch_size)
    em_dev = EdgeStaticMeta.from_layout(layout).to(dev)
    res = {}
    for rm in (False, True):
        c = cfg.replace(dropout=0.0, remat=rm)
        model = node_classifier(c, layout, item.tb.sub.node_feat.shape[-1],
                                task.n_classes, seed=3).to(dev)
        args = label_args(item.tb, item.se, model)(dev)
        loss_fn = task.make_loss_fn(model, em_dev)
        loss_fn(None, *args).backward()          # warm-up
        model.zero_grad(set_to_none=True)
        _sync(dev)
        _reset_peak(dev)
        reset_counts()
        loss = loss_fn(None, *args)
        loss.backward()
        _sync(dev)
        res[rm] = (loss.item(), read_counts(), _peak_gib(dev),
                   {n: p.grad.detach().float().cpu()
                    for n, p in model.named_parameters()})
        del model, args, loss_fn, loss
        torch.cuda.empty_cache()
    (l0, c0, p0, g0), (l1, c1, p1, g1) = res[False], res[True]
    step = {"live_partials": 3, "softmax": 2}
    want = {k: step.get(k, 0) * cfg.n_layers for k in NO_LAUNCH}
    want["pair_window"] = c1["pair_window"]
    want["pair_runs"] = OGBN_PAIR * cfg.n_layers - c1["pair_window"]
    err = grads_err(g1, g0)
    ok = (l1 == l0 or abs(l1 - l0) <= 1e-6 * abs(l0)) and err <= SPREAD_TOL \
        and c1 == want and c0 == ogbn_expected(cfg.n_layers, 1, 0, c0)
    log(f"[remat-ogbn] an [ogbn] item at the ogbn_mag preset (softmax "
        f"kernel on), dropout 0: loss {l1:.6f} with remat, {l0:.6f} without; "
        f"gradients max err {err:.2e} of scale (tol {SPREAD_TOL:g}); "
        f"launches of one step {c1} with remat (expected {want}), {c0} "
        f"without; peak {p1:.3f} GiB with, {p0:.3f} GiB without "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[remat-ogbn] remat disagrees on the ogbn path")
    return c1


def phase_remat(dev, batch, labels):
    """[remat]: the bench preset's gradients with the edge core recomputed
    in the backward (``remat``) against the same step without it (dropout
    0), beside the run-to-run spread of the step without; ms per step,
    peak memory and launches of both. Returns the launches of the timed
    steps."""
    l0, g0, _ = grads_of(dev, batch, labels)
    l0b, g0b, _ = grads_of(dev, batch, labels)
    l1, g1, dtypes = grads_of(dev, batch, labels, remat=True)
    spread, err = grads_err(g0b, g0), grads_err(g1, g0)
    ok = (abs(l1 - l0) <= 1e-6 * abs(l0) and err <= SPREAD_TOL
          and dtypes == {"torch.float32"})
    log(f"[remat] bench preset, dropout 0: loss {l1:.6f} with remat, "
        f"{l0:.6f} and {l0b:.6f} without (twice); gradients max err "
        f"{err:.2e} of scale against the step without (tol {SPREAD_TOL:g}), "
        f"the step without against itself {spread:.2e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[remat] remat changes the gradients")
    _, ms0, peak0 = steps_and_peak("remat", dev, batch, labels, MAIN_STEP)
    counts, ms1, peak1 = steps_and_peak("remat", dev, batch, labels,
                                        REMAT_STEP, remat=True)
    log(f"[remat] step {ms1:.2f} ms with remat against {ms0:.2f} ms without; "
        f"peak {peak1:.3f} GiB against {peak0:.3f} GiB | {card_line()}")
    return counts


def phase_acc(dev):
    """[acc]: ``make_train_step_acc`` with A = 2 (the batches of seeds 0
    and 1, dropout 0) against a hand-made step on the averaged gradients
    (two backwards summed, halved, one update) from the same weights: the
    mean loss, the gradients the update reads; ms of one accumulated step
    against two default steps (in turns). Returns the launches of the
    accumulated steps."""
    fa, sa, _ = bench_state(dev, dropout=0.0)
    fb, sb, step_b = bench_state(dev, dropout=0.0)
    micro = []
    for seed in (0, 1):
        batch, labels = synth_flagship_batch(fa, seed=seed)
        micro.append(fa.to_device(batch, fa.sort(batch), labels))
    stacked = tuple(zip(*micro))
    seen = {}

    def capture(opt, model):
        """Keep the gradients ``opt``'s update reads, by parameter name."""
        inner_step = opt.step

        def step():
            seen[id(opt)] = {n: p.grad.detach().float().cpu()
                             for n, p in model.named_parameters()}
            inner_step()
        opt.step = step

    capture(sa.optimizer, fa.model)
    capture(sb.optimizer, fb.model)
    acc = make_train_step_acc(lambda gen, *mb: fa.loss(*mb), sa.optimizer)
    loss_acc = float(acc(None, *stacked))
    sb.optimizer.zero_grad()
    losses = []
    for mb in micro:
        loss = fb.loss(*mb)
        loss.backward()
        losses.append(loss.item())
    for p in sb.optimizer.params:
        p.grad.div_(2.0)
    sb.optimizer.step()
    want_loss = (losses[0] + losses[1]) / 2
    err = grads_err(seen[id(sa.optimizer)], seen[id(sb.optimizer)])
    ok = (abs(loss_acc - want_loss) <= 1e-6 * abs(want_loss)
          and err <= SPREAD_TOL and sa.step == sb.step == 1)
    log(f"[acc] A = 2 (seeds 0, 1), dropout 0: mean loss {loss_acc:.6f} "
        f"against the hand-made step's {want_loss:.6f}; the averaged "
        f"gradients the update reads, max err {err:.2e} of scale (tol "
        f"{SPREAD_TOL:g}); one update each {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[acc] the accumulated step disagrees")
    for opt in (sa.optimizer, sb.optimizer):
        del opt.step
    float(acc(None, *stacked))
    float(step_b(*micro[0]))

    def two_steps():
        step_b(*micro[0])
        return step_b(*micro[1])

    reset_counts()
    ms = {"acc": [], "two": []}
    for name, fn, a in (("acc", acc, (None, *stacked)), ("two", two_steps, ()),
                        ("two", two_steps, ()), ("acc", acc, (None, *stacked))):
        ms[name].append(timed_steps(fn, a))
    counts = read_counts()
    want = scaled(MAIN_STEP, fa.cfg.n_layers * 2 * 4 * N_STEPS)
    log(f"[acc] one accumulated step of 2 microbatches {np.mean(ms['acc']):.2f}"
        f" ms ({ms['acc'][0]:.2f}, {ms['acc'][1]:.2f}) against two default "
        f"steps {np.mean(ms['two']):.2f} ms ({ms['two'][0]:.2f}, "
        f"{ms['two'][1]:.2f}), {N_STEPS} calls x 2 turns each; launches "
        f"{counts} (expected {want}) {'ok' if counts == want else 'FAIL'} | "
        f"{card_line()}")
    if counts != want:
        raise AssertionError(f"[acc] launches {counts}")
    return {k: v // 2 for k, v in counts.items()}


# the predictor phase: the ogbn-mag proxy at this scale of the real counts
# (73,638 papers, 113,464 authors, ~4.2 M directed edges: per-type degrees,
# and so the sampled subgraphs' fan-outs, are those of full scale)
PROXY_SCALE = 0.1
# (request size, vr_num) of the 8 served requests; 256 nodes are two chunks
# of the preset's batch of 128
PREDICTOR_REQUESTS = [(n, vr) for vr in (1, 2) for n in (1, 16, 128, 256)]
NATIVE_ENTRIES = ("hgs_sample", "sb_counting_sort", "sb_permute_build",
                  "sb_tiled_aux", "sb_pallas_aux", "sb_tab_window_aux")
# per layer of a predictor forward: the legacy target aux (the predictor
# sorts with no rank cap), so live_partials for the wide sum and, under
# softmax_pallas, the softmax partials
PREDICTOR_FORWARD = {"live_partials": 1, "softmax": 1}


def served_config():
    """The slice's configuration: the ogbn_mag preset with the CLI's
    ``--seg_pallas --edge_bf16 --softmax_pallas``."""
    return PRESETS["ogbn_mag"].replace(seg_pallas=True, edge_bf16=True,
                                       softmax_pallas=True)


def predictor_graph(workdir):
    """Build the proxy, write it with ``save_dir`` and read it back
    memory-mapped, as ``run serve --data`` reads it."""
    t0 = time.perf_counter()
    g = build_proxy(PROXY_SCALE, seed=0)
    t1 = time.perf_counter()
    g.save_dir(str(workdir / "graph"))
    del g
    t2 = time.perf_counter()
    g = CSRGraph.load_dir(str(workdir / "graph"), mmap=True)
    t3 = time.perf_counter()
    n_cls = int(np.asarray(g.aux["y"]).max()) + 1
    in_dim = g.features["paper"]["emb"].shape[1]
    log(f"[predictor] proxy at scale {PROXY_SCALE}: {g} ({n_cls} classes, "
        f"paper input {in_dim}); build {t1 - t0:.2f} s, save_dir "
        f"{t2 - t1:.2f} s, load_dir(mmap) {t3 - t2:.3f} s")
    if n_cls != 349 or in_dim != 129:
        raise AssertionError("the proxy lost its ogbn-mag classes or width")
    return g


def native_counts():
    return {k: native_build.CALLS[k] for k in NATIVE_ENTRIES}


def phase_predictor(dev, workdir):
    """The port's serving path for real: checkpoint -> OgbnPredictor ->
    JSON-lines requests through the C++ sampler, pad_sample, the C++ host
    sort and the forward on the card, with its kernels counted."""
    cfg = served_config()
    g = predictor_graph(workdir)
    ckpt = str(workdir / "ckpt")
    layout = make_layout(cfg, g)
    model = node_classifier(cfg, layout, g.features["paper"]["emb"].shape[1],
                            int(np.asarray(g.aux["y"]).max()) + 1, seed=1)
    save_checkpoint(ckpt, TrainState(
        model, make_tx(cfg, model.named_parameters(), 1)))
    t0 = time.perf_counter()
    pred = OgbnPredictor(cfg, g, ckpt, log=log, device=dev)
    log(f"[predictor] OgbnPredictor on {dev} in "
        f"{time.perf_counter() - t0:.2f} s: sampler "
        f"{type(pred.task.sampler).__name__}, layout node cap "
        f"{layout.node_cap}, {layout.num_edges} padded edges")
    if type(pred.task.sampler).__name__ != "NativeHGSampler":
        raise AssertionError("the predictor did not take the C++ sampler")
    restored = pred.model.state_dict()
    diff = [k for k, v in model.state_dict().items()
            if not torch.equal(restored[k].cpu(), v)]
    log(f"[predictor] checkpoint restore: {len(restored)} tensors, "
        f"{sum(v.numel() for v in restored.values())} values, "
        f"{len(diff)} not bit-equal to what was written")
    if diff or restored.keys() != model.state_dict().keys():
        raise AssertionError(f"checkpoint restore differs: {diff}")

    rng = np.random.default_rng(42)
    n_paper = g.num_nodes["paper"]

    def request(n, vr):
        return {"nodes": rng.choice(n_paper, n, replace=False).tolist(),
                "vr_num": vr}

    def serve_one(req):
        out = io.StringIO()
        t0 = time.perf_counter()
        served = serve_jsonl(pred, stdin=io.StringIO(json.dumps(req) + "\n"),
                             stdout=out, log=lambda s: None)
        ms = (time.perf_counter() - t0) * 1e3
        resp = json.loads(out.getvalue())
        if served != 1 or "error" in resp:
            raise AssertionError(f"request failed: {resp.get('error')}")
        return resp, ms

    serve_one(request(128, 1))                  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    pred.stats.clear()
    reset_counts()
    before = native_counts()
    rows = []
    for n, vr in PREDICTOR_REQUESTS:
        req = request(n, vr)
        k = len(pred.stats)
        resp, total = serve_one(req)
        st = pred.stats[k:]
        lp = np.asarray(resp["logp"])
        ok = (resp["nodes"] == req["nodes"] and len(resp["pred"]) == n
              and lp.shape == (n, pred.n_classes)
              and bool(np.isfinite(lp).all()) and bool((lp < 0).all())
              and all(0 <= c < pred.n_classes for c in resp["pred"]))
        row = {"nodes": n, "vr_num": vr, "forwards": len(st),
               "sample_ms": sum(x["sample_ms"] for x in st),
               "sort_ms": sum(x["sort_ms"] for x in st),
               "forward_ms": sum(x["forward_ms"] for x in st),
               "total_ms": total,
               "edges": [x["edges"] for x in st]}
        rows.append(row)
        log(f"[predictor] request {len(rows)}: {n} nodes, vr_num {vr}, "
            f"{len(st)} forward(s) | sampler {row['sample_ms']:.2f} ms, host "
            f"sort {row['sort_ms']:.2f} ms, forward {row['forward_ms']:.2f} "
            f"ms, total {total:.2f} ms | valid edges {row['edges']} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"request {len(rows)}: bad answer")
    counts = read_counts()
    natives = {k: v - before[k] for k, v in native_counts().items()}
    for key in ("sample_ms", "sort_ms", "forward_ms", "total_ms"):
        vals = [r[key] for r in rows]
        log(f"[predictor] {key} per request over {len(rows)}: mean "
            f"{np.mean(vals):.2f}, max {np.max(vals):.2f}")
    forwards = sum(r["forwards"] for r in rows)
    per_fwd = {key: sum(x[key] for x in pred.stats) / forwards
               for key in ("sample_ms", "sort_ms", "forward_ms")}
    edges = [e for r in rows for e in r["edges"]]
    log(f"[predictor] per forward over {forwards}: sampler "
        f"{per_fwd['sample_ms']:.2f} ms, host sort {per_fwd['sort_ms']:.2f} "
        f"ms, forward {per_fwd['forward_ms']:.2f} ms; valid edges mean "
        f"{np.mean(edges):.1f} (min {min(edges)}, max {max(edges)}) of "
        f"{layout.num_edges} padded -> {np.mean(edges) / (per_fwd['forward_ms'] / 1e3):.6g} "
        f"edges/s (forward)")
    expected = scaled(PREDICTOR_FORWARD, cfg.n_layers * forwards)
    log(f"[predictor] kernel launches {counts} over {forwards} forwards "
        f"(expected per layer and forward {PREDICTOR_FORWARD} and no other "
        f"launch); C++ entry calls {natives}")
    if forwards != sum(-(-n // cfg.batch_size) * vr
                       for n, vr in PREDICTOR_REQUESTS):
        raise AssertionError(f"{forwards} forwards")
    if counts != expected:
        raise AssertionError("the predictor's launches differ")
    if natives["hgs_sample"] != forwards or \
            natives["sb_permute_build"] != forwards:
        raise AssertionError("the C++ sampler or the C++ sort did not run "
                             "once per forward")
    return pred, counts, rows


def phase_predictor_parts(pred):
    """The sampler's part of a request by step, for 128 paper seeds (3
    draws): the C++ sampler, the feature gather from the memory-mapped
    graph, ``pad_sample``; and what the sample holds."""
    task = pred.task
    rng = np.random.default_rng(10)
    ms = {"sample_raw": [], "gather_features": [], "pad_sample": []}
    for _ in range(3):
        ids = rng.choice(task.graph.num_nodes["paper"], 128, replace=False)
        seeds = {"paper": np.stack([ids, task.years[ids]], axis=1)}
        t0 = time.perf_counter()
        raw = task.sampler.sample_raw(seeds, rng=rng)
        t1 = time.perf_counter()
        feats = gather_features(task.graph, raw)
        t2 = time.perf_counter()
        sub = pad_sample(raw, task.layout, feats, rng=rng)
        t3 = time.perf_counter()
        for k, dt in zip(ms, (t1 - t0, t2 - t1, t3 - t2)):
            ms[k].append(dt * 1e3)
    nodes = {t: len(v) for t, v in raw.node_ids.items()}
    edges = sum(len(e[0]) for e in raw.edges.values())
    log(f"[predictor-parts] 128 seeds, 3 draws, mean ms: " + ", ".join(
        f"{k} {np.mean(v):.2f}" for k, v in ms.items()) + f"; last draw: "
        f"nodes {nodes}, {edges} sampled edges; the batch: "
        f"{int(sub.edge_mask.sum())} valid edges (self loops included), "
        f"{int(sub.block_overflow.sum())} dropped by the edge caps")


def phase_predictor_sort(pred):
    """One served batch sorted by the C++ path and by the numpy path: every
    field bit-equal; both timed (serving sort and the backward's too)."""
    sub = pred.last_batch.sub
    args = (sub.edge_src, sub.edge_tgt, sub.edge_dt, sub.edge_mask,
            pred.layout, pred.em)
    for with_backward in (False, True):
        ms, got = {}, {}
        for native in (True, False, True, False):
            t0 = time.perf_counter()
            got[native] = sort_edges(*args, native=native,
                                     with_backward=with_backward)
            ms.setdefault(native, []).append(
                (time.perf_counter() - t0) * 1e3)
        bad = sorted_differences(got[True], got[False])
        log(f"[predictor-sort] with_backward={with_backward}: C++ "
            f"{min(ms[True]):.2f} ms, numpy {min(ms[False]):.2f} ms (best of "
            f"2 each); fields not bit-equal: {bad or 'none'}")
        if bad:
            raise AssertionError(f"C++ and numpy sorts differ: {bad}")


def sorted_differences(a, b):
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, PallasSegAux):
            same = all(np.array_equal(getattr(x, k), getattr(y, k))
                       for k in ("loc", "blk", "ptr2", "live_key")
                       if getattr(x, k) is not None) and \
                (x.w, x.v, x.window) == (y.w, y.v, y.window)
        elif isinstance(x, np.ndarray):
            same = x.dtype == y.dtype and np.array_equal(x, y)
        else:
            same = x == y
        if not same:
            bad.append(f.name)
    return bad


def phase_predictor_cpu(pred, workdir):
    """The same request, the same generator, on a CPU predictor (the plain
    path): the same sampled subgraph, log-probs within CPU_TOL."""
    cpu = OgbnPredictor(pred.cfg, pred.task.graph, str(workdir / "ckpt"),
                        log=log, device="cpu")
    ids = np.random.default_rng(8).choice(pred.task.graph.num_nodes["paper"],
                                          16, replace=False)
    got = pred.predict_logprobs(ids, vr_num=1, rng=np.random.default_rng(7))
    t0 = time.perf_counter()
    want = cpu.predict_logprobs(ids, vr_num=1, rng=np.random.default_rng(7))
    a, b = pred.last_batch, cpu.last_batch
    same_nodes = (np.array_equal(a.target_ids, b.target_ids)
                  and np.array_equal(a.sub.edge_src, b.sub.edge_src)
                  and np.array_equal(a.sub.edge_tgt, b.sub.edge_tgt))
    err = float(np.abs(got - want).max())
    ok = same_nodes and err <= CPU_TOL
    log(f"[predictor-cpu] 16 nodes, vr_num 1, default_rng(7): CPU predictor "
        f"in {time.perf_counter() - t0:.1f} s; same sampled nodes and edges "
        f"{same_nodes}; max |GPU - CPU| accumulated log-prob {err:.3e} (tol "
        f"{CPU_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the GPU and CPU predictors disagree")


class CallCounter:
    """A predictor that records each ``predict_logprobs`` call."""

    def __init__(self, pred):
        self.pred, self.calls = pred, []
        self.n_classes = pred.n_classes

    def predict_logprobs(self, nodes, vr_num=None, rng=None):
        self.calls.append(len(nodes))
        return self.pred.predict_logprobs(nodes, vr_num=vr_num, rng=rng)


def phase_predictor_burst(pred):
    """A burst of 4 requests through the coalescing transport
    (``coalesce_wait=0.05``): one predictor call, answers in order."""
    rng = np.random.default_rng(9)
    reqs = [{"nodes": rng.choice(pred.task.graph.num_nodes["paper"], n,
                                 replace=False).tolist(), "vr_num": 1}
            for n in (1, 8, 16, 32)]
    wrapped, out = CallCounter(pred), io.StringIO()
    t0 = time.perf_counter()
    served = serve_jsonl(wrapped, stdin=io.StringIO(
        "".join(json.dumps(r) + "\n" for r in reqs)), stdout=out,
        log=lambda s: None, coalesce_wait=0.05)
    ms = (time.perf_counter() - t0) * 1e3
    resp = [json.loads(x) for x in out.getvalue().splitlines()]
    ok = (served == 4 and wrapped.calls == [57]
          and [r["nodes"] for r in resp] == [r["nodes"] for r in reqs]
          and all(len(r["pred"]) == len(q["nodes"])
                  for r, q in zip(resp, reqs)))
    log(f"[predictor-burst] 4 requests (1, 8, 16, 32 nodes) with "
        f"coalesce_wait 0.05: predictor calls {wrapped.calls}, answers in "
        f"request order {ok}, {ms:.1f} ms for the burst "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the coalesced burst was not one call in order")


def phase_predictor_cli(workdir):
    """``python -m pyhgt_tpu_torch.run serve`` as a user runs it, with 2
    requests on stdin."""
    reqs = [{"nodes": [0, 5, 9], "vr_num": 1}, {"nodes": [123], "vr_num": 2}]
    cmd = [sys.executable, "-m", "pyhgt_tpu_torch.run", "serve", "--data",
           str(workdir / "graph"), "--ckpt", str(workdir / "ckpt"),
           "--seg_pallas", "--edge_bf16", "--softmax_pallas"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, input="".join(json.dumps(r) + "\n"
                                             for r in reqs),
                          capture_output=True, text=True, timeout=600,
                          cwd=str(ROOT))
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    ok = proc.returncode == 0 and len(lines) == 2
    if ok:
        resp = [json.loads(x) for x in lines]
        ok = all(len(r["pred"]) == len(q["nodes"]) and r["nodes"] == q["nodes"]
                 and all(0 <= c < 349 for c in r["pred"])
                 for r, q in zip(resp, reqs))
    log(f"[predictor-cli] {' '.join(cmd[1:4])} ... --seg_pallas --edge_bf16 "
        f"--softmax_pallas: exit {proc.returncode} in {secs:.1f} s, "
        f"{len(lines)} answer lines {'ok' if ok else 'FAIL'}")
    if not ok:
        log(proc.stderr[-4000:])
        raise AssertionError("the CLI did not answer both requests")


# the [ogbn] phase: the ogbn_mag preset trained on the proxy graph, cut in
# length only (the preset's n_epoch 100, n_batch 32, the whole test split
# at vr_num 8)
OGBN_CUTS = dict(n_epoch=2, n_batch=6, vr_num=2)
OGBN_EVAL_NODES = 256
# launches per layer of a train step and of a forward (validation, VR
# evaluation) on the slice's path: the preset's caps are 0, so the legacy
# target aux, which the softmax kernel reads; the pair kernel reduces the
# src grouping on its runs aux and the tab grouping on the window aux, or,
# where a tile spans more than two meta blocks, on its runs aux
OGBN_STEP = {"live_partials": 2, "softmax": 1}
OGBN_PAIR = 2
OGBN_FORWARD = PREDICTOR_FORWARD


def ogbn_expected(n_layers, steps, forwards, counts):
    """The launches a run of ``steps`` train steps and ``forwards``
    evaluation forwards must count; the pair's split between its two aux
    kinds is read from ``counts``, their sum is fixed."""
    want = {k: (OGBN_STEP.get(k, 0) * steps + OGBN_FORWARD.get(k, 0)
                * forwards) * n_layers for k in NO_LAUNCH}
    want["pair_window"] = counts["pair_window"]
    want["pair_runs"] = OGBN_PAIR * n_layers * steps - counts["pair_window"]
    return want


def device_busy_share(prof, span):
    """The card's busy time inside the host-side profiler span named
    ``span``: the union of the intervals of its kernels, copies and fills
    within the span. Device-side annotations (the GPU mirror of each
    ``record_function`` range, named as on the host) are not device work
    and are left out. Returns (busy ms, span ms)."""
    from torch.autograd import DeviceType

    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    spans = [e.time_range for e in events
             if e.name == span and e.device_type == DeviceType.CPU]
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA
                 and e.name not in host_names)
    busy = total = 0.0
    for sp in spans:
        total += sp.end - sp.start
        cur_s = cur_e = None
        for a, b in dev:
            a, b = max(a, sp.start), min(b, sp.end)
            if b <= a:
                continue
            if cur_e is None or a > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        if cur_e is not None:
            busy += cur_e - cur_s
    return busy / 1e3, total / 1e3


def phase_ogbn(dev, graph, workdir, profile=False):
    """The port's product path at the ogbn_mag preset's full width on the
    proxy graph: ``run_ogbn`` trains (the loader's threads sample and sort,
    the steps run on the card), validates, checkpoints and VR-evaluates;
    a resumed run trains one more epoch; one producer item's loss and
    gradient norm on the card against the CPU's plain path; the best
    checkpoint evaluated by ``evaluate_ogbn`` in both modes and served by
    an ``OgbnPredictor``. Every kernel launch counted and asserted."""
    t_phase = time.perf_counter()
    model_dir = workdir / "ogbn"
    cfg = served_config().replace(model_dir=str(model_dir), **OGBN_CUTS)
    L = cfg.n_layers
    steps = cfg.n_batch * cfg.repeat
    n_test = int(np.asarray(graph.aux["test_mask"]).sum())
    vr_forwards = -(-min(OGBN_EVAL_NODES, n_test) // cfg.batch_size)
    log(f"[ogbn] run_ogbn at the ogbn_mag preset (n_hid {cfg.n_hid}, "
        f"{cfg.n_heads} heads, {L} layers, depth {cfg.sample_depth}, width "
        f"{cfg.sample_width}, batch {cfg.batch_size}, calibrated caps, n_pool "
        f"{cfg.n_pool}, repeat {cfg.repeat}) with --seg_pallas --edge_bf16 "
        f"--softmax_pallas on the proxy at scale {PROXY_SCALE}; cut in "
        f"length only: n_epoch {cfg.n_epoch} (preset 100), n_batch "
        f"{cfg.n_batch} (32), vr_num {cfg.vr_num} (8), max_eval_nodes "
        f"{OGBN_EVAL_NODES} of {n_test} test papers")
    logs = []

    def tee(msg):
        logs.append(msg)
        log(f"[ogbn]   {msg}")

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = run_ogbn(cfg, graph, log=tee, max_eval_nodes=OGBN_EVAL_NODES,
                   device=dev)
    secs = time.perf_counter() - t0
    counts = read_counts()
    hist = out["history"]
    for h in hist:
        log(f"[ogbn] epoch {h['epoch']}: loss {h['loss']:.4f}; step "
            f"{h['step_ms']:.2f} ms mean, {h['step_ms_max']:.2f} max (the "
            f"{steps - 1} steps after the epoch's first, by CUDA events); "
            f"loader wait {h['wait_ms']:.2f} ms/step; train "
            f"{h['edges_per_s']:.6g} edges/s ({h['edges']} valid edges x "
            f"{L} layers over the epoch's {h['secs']:.2f} s, validation and "
            f"checkpoints included); valid acc {h['valid_acc']:.4f}; edges "
            f"dropped by the caps {h['edges_dropped']}")
    test = out["test"]
    log(f"[ogbn] run_ogbn in {secs:.1f} s: test acc (VR) {test['acc']:.4f}, "
        f"seq_acc {test['seq_acc']:.4f}, n_eval {test['n_eval']}, vr_curve "
        f"{test['vr_curve']}")
    files = [model_dir / "ogbn_mag_metrics.jsonl",
             model_dir / "ogbn_mag_hgt" / "state.pt",
             model_dir / "ogbn_mag_hgt_latest" / "state.pt"]
    missing = [str(f) for f in files if not f.exists()]
    # a mean of finite f32 losses is finite, and a non-finite one is not
    if len(hist) != cfg.n_epoch or not all(
            np.isfinite(h["loss"]) for h in hist) or missing:
        raise AssertionError(f"[ogbn] training failed: {hist}, missing "
                             f"{missing}")
    forwards = 4 * cfg.n_epoch + vr_forwards * cfg.vr_num
    want = ogbn_expected(L, steps * cfg.n_epoch, forwards, counts)
    log(f"[ogbn] kernel launches {counts} over {steps * cfg.n_epoch} steps "
        f"and {forwards} forwards (expected per layer and step {OGBN_STEP} + "
        f"pair {OGBN_PAIR} (runs or window: the window aux held in "
        f"{counts['pair_window']} of {L * steps * cfg.n_epoch} layer-steps), "
        f"per layer and forward {OGBN_FORWARD})")
    if counts != want or counts["pair_runs"] < L * steps * cfg.n_epoch:
        raise AssertionError(f"[ogbn] launches {counts} != {want}")

    # resume: one more epoch from the latest checkpoint
    logs.clear()
    t0 = time.perf_counter()
    resume = cfg.replace(n_epoch=cfg.n_epoch + 1)
    if profile:
        with profile_trace(str(workdir / "ogbn_trace")) as prof:
            again = run_ogbn(resume, graph, log=tee, resume=True,
                             max_eval_nodes=cfg.batch_size, device=dev)
        busy, span = device_busy_share(prof, TRAIN_SPAN)
        unprofiled = hist[-1]["step_ms"]
        log(f"[ogbn-profile] resumed epoch under torch.profiler: the card "
            f"busy {busy:.1f} of the {steps} train steps' {span:.1f} ms "
            f"(kernels, copies and fills, union of intervals): idle share "
            f"{1 - busy / span:.3f} under the profiler; busy {busy / steps:.2f}"
            f" ms per step against the unprofiled epoch {hist[-1]['epoch']}'s"
            f" {unprofiled:.2f} ms step: idle share "
            f"{1 - busy / steps / unprofiled:.3f} at that pace")
        log(f"[ogbn-profile] the resumed run's top CUDA ops (its epoch's "
            f"{steps} steps, 4 validation and {cfg.vr_num} VR forwards):")
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25))
    else:
        again = run_ogbn(resume, graph, log=tee, resume=True,
                         max_eval_nodes=cfg.batch_size, device=dev)
    epochs = [h["epoch"] for h in again["history"]]
    ok = epochs == [cfg.n_epoch] and any(
        "resumed" in m and f"at epoch {cfg.n_epoch}" in m for m in logs)
    log(f"[ogbn-resume] n_epoch {resume.n_epoch} with resume=True: trained "
        f"epochs {epochs} in {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[ogbn-resume] did not resume for one epoch")

    phase_ogbn_cpu(dev, graph, cfg)

    best = str(model_dir / "ogbn_mag_hgt")
    for mode, vr in (("variance_reduce", cfg.vr_num), ("sequential", 1)):
        reset_counts()
        t0 = time.perf_counter()
        res = evaluate_ogbn(cfg, graph, best, eval_mode=mode,
                            max_eval_nodes=OGBN_EVAL_NODES, log=lambda s: None,
                            device=dev)
        ms = (time.perf_counter() - t0) * 1e3
        got = read_counts()
        n_fwd = vr_forwards * vr
        want = scaled(OGBN_FORWARD, L * n_fwd)
        ok = got == want and 0 <= res["acc"] <= 1 and res["n_eval"] > 0
        log(f"[ogbn-eval] evaluate_ogbn({mode}) of the best checkpoint: acc "
            f"{res['acc']:.4f}, seq_acc {res['seq_acc']:.4f}, n_eval "
            f"{res['n_eval']}; {n_fwd} forwards, {ms:.0f} ms with the "
            f"predictor's build; launches {got} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[ogbn-eval] {mode}: {got} != {want}")
    # the same VR evaluation on a predictor of its own, each forward's
    # host sort and forward timed (pred.stats), then one served request
    t0 = time.perf_counter()
    pred = OgbnPredictor(cfg, graph, best, log=lambda s: None, device=dev)
    build_s = time.perf_counter() - t0
    pred.stats.clear()
    t0 = time.perf_counter()
    vr = multi_sample_eval(pred.eval_forward, pred.params, pred.task,
                           split="test", batch_size=cfg.batch_size,
                           vr_num=cfg.vr_num,
                           rng=np.random.default_rng(cfg.seed + 3),
                           max_nodes=OGBN_EVAL_NODES)
    ms = (time.perf_counter() - t0) * 1e3
    n_fwd = len(pred.stats)
    log(f"[ogbn-eval] VR evaluation on a predictor (built in {build_s:.2f} "
        f"s): acc {vr['acc']:.4f}, {n_fwd} forwards, {ms / n_fwd:.1f} ms per "
        f"forward with the sampler; host sort "
        f"{np.mean([x['sort_ms'] for x in pred.stats]):.2f} ms, forward "
        f"{np.mean([x['forward_ms'] for x in pred.stats]):.2f} ms (mean)")
    test_nodes = np.where(np.asarray(graph.aux["test_mask"]))[0]
    req = {"nodes": test_nodes[:3].tolist(), "vr_num": 1}
    buf = io.StringIO()
    served = serve_jsonl(pred, stdin=io.StringIO(json.dumps(req) + "\n"),
                         stdout=buf, log=lambda s: None)
    resp = json.loads(buf.getvalue())
    ok = (served == 1 and resp.get("nodes") == req["nodes"]
          and all(0 <= c < pred.n_classes for c in resp.get("pred", [-1])))
    log(f"[ogbn-serve] the trained checkpoint served by an OgbnPredictor: "
        f"test papers {req['nodes']} -> classes {resp.get('pred', resp)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[ogbn-serve] the trained checkpoint did not serve")
    log(f"[ogbn] phase done in {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_ogbn_cpu(dev, graph, cfg):
    """One producer item (the loader's path: sample, pad, the C++ sort
    with the backward's aux), the same starting weights, dropout 0: loss
    and global gradient norm on the card against the CPU's plain path;
    the step's launches counted alone."""
    cfg = cfg.replace(dropout=0.0)
    sampler = make_sampler(cfg, graph, log=log)
    layout = make_layout(cfg, graph)
    em = EdgeStaticMeta.from_layout(layout)
    task = OgbnNodeTask(graph=graph, sampler=sampler, layout=layout,
                        batch_size=cfg.batch_size)
    item = _make_producer(task.make_sample_fn("train"), layout, em)(
        np.random.default_rng(12))
    tb = item.tb
    log(f"[ogbn-cpu] one producer item: {item.n_edges} valid edges, "
        f"{item.overflow} dropped (the uncalibrated layout)")
    model = node_classifier(cfg, layout, tb.sub.node_feat.shape[-1],
                            task.n_classes, seed=3)
    card_against_cpu("ogbn-cpu", dev, model,
                     lambda m, d: task.make_loss_fn(m, em.to(d)),
                     label_args(tb, item.se, model), cfg.n_layers)


# the OAG phases: the OAG proxy (the repo's examples/oag_scale_proxy.py
# build) cut to this scale of its OAG-CS magnitudes: ~54k papers, ~51k
# authors, ~4.5k fields, ~600 venues, ~900 affiliations, ~200 L2 label
# fields; per-type degrees, so fan-outs, are full scale's
OAG_SCALE = 0.1
# the proxy has no author names: as the toy graph of the tests names its
# authors, name{a % (n_author // AUTHORS_PER_NAME)}
AUTHORS_PER_NAME = 16
# each OAG runner cut in length only: 1 epoch of n_batch 4 x the preset's
# repeat 2 (the presets: 200 epochs of 32 x 2)
OAG_CUTS = dict(n_epoch=1, n_batch=4)
OAG_FLAGS = dict(seg_pallas=True, edge_bf16=True, softmax_pallas=True)
# forwards of an OAG run: one validation batch per epoch, 10 test batches
OAG_TEST_BATCHES = 10
# [link-serve]: the index over this many grouped authors, then requests of
# these sizes (papers), one at a time after one warm-up
LINK_INDEX_AUTHORS = 2048
LINK_REQUESTS = [1, 4, 16, 64, 128, 256, 32, 8]
LINK_K = 10


def oag_config(task, workdir):
    """The task's preset (n_hid 400, 8 heads, 4 layers, depth 6, width
    128, batch 256) with the slice's flags, cut in length only."""
    return PRESETS[task].replace(model_dir=str(workdir / task), **OAG_FLAGS,
                                 **OAG_CUTS)


def oag_graph(workdir):
    """Build the proxy, name its authors, write it with ``save_dir`` and
    read it back memory-mapped, as ``run --data`` reads it."""
    t0 = time.perf_counter()
    g = build_oag_proxy(OAG_SCALE, seed=0)
    n_author = g.num_nodes["author"]
    n_names = n_author // AUTHORS_PER_NAME
    g.features["author"]["name"] = np.array(
        [f"name{a % n_names}" for a in range(n_author)])
    t1 = time.perf_counter()
    g.save_dir(str(workdir / "oag_graph"))
    del g
    g = CSRGraph.load_dir(str(workdir / "oag_graph"), mmap=True)
    t2 = time.perf_counter()
    n_l2 = int((np.diff(g.adj[OAG_FIELD_LABEL].indptr) > 0).sum())
    log(f"[oag] proxy at scale {OAG_SCALE}: {g}; {n_l2} L2 label fields, "
        f"paper input {oag_in_dim(g)}; {n_names} author names; build "
        f"{t1 - t0:.2f} s, save_dir + load_dir(mmap) {t2 - t1:.2f} s")
    if oag_in_dim(g) != 529:
        raise AssertionError("the proxy lost the OAG input width")
    groups = build_name_groups(g)
    pairs = build_link_pairs(g, groups, OAG_SPLITS)
    names = {k: len(v) for k, v in pairs.items()}
    n_pairs = {k: sum(len(x) for x in v.values()) for k, v in pairs.items()}
    need = PRESETS["author_disambiguation"].batch_size // 4
    log(f"[oag] author disambiguation: {len(groups)} name groups of at least "
        f"4 authors with 2+ first-authored papers ({sum(map(len, groups.values()))}"
        f" authors); names per split {names}, (paper, author) pairs per "
        f"split {n_pairs}; at least {need} names needed per split")
    if min(names.values()) < need:
        raise AssertionError("a split has too few names for a batch")
    return g


OAG_FIELD_LABEL = ("field", "paper", "PF_in_L2")


def layout_line(logs):
    """The runner's own ``layout:`` log line."""
    return next(m for m in logs if m.startswith("layout:"))


def oag_launches(tag, counts, cfg, steps, forwards):
    """Assert the launches of ``steps`` train steps and ``forwards``
    evaluation forwards on the OAG path (the presets' caps are 0: the
    legacy target aux, as on the ogbn-mag path)."""
    want = ogbn_expected(cfg.n_layers, steps, forwards, counts)
    L = cfg.n_layers
    ok = counts == want and counts["pair_runs"] >= L * steps
    log(f"[{tag}] kernel launches {counts} over {steps} steps and "
        f"{forwards} forwards (expected per layer and step {OGBN_STEP} + pair "
        f"{OGBN_PAIR}: the window aux held in {counts['pair_window']} of "
        f"{L * steps} layer-steps; per layer and forward {OGBN_FORWARD}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] launches {counts} != {want}")


def epoch_lines(tag, out, cfg):
    steps = cfg.n_batch * cfg.repeat
    for h in out["history"]:
        log(f"[{tag}] epoch {h['epoch']}: loss {h['loss']:.4f}; step "
            f"{h['step_ms']:.2f} ms mean, {h['step_ms_max']:.2f} max (the "
            f"{steps - 1} steps after the epoch's first, by CUDA events); "
            f"loader wait {h['wait_ms']:.2f} ms/step; train "
            f"{h['edges_per_s']:.6g} edges/s ({h['edges']} valid edges x "
            f"{cfg.n_layers} layers over the epoch's {h['secs']:.2f} s, "
            f"validation and checkpoints included); valid NDCG "
            f"{h['valid_ndcg']:.4f}, MRR {h['valid_mrr']:.4f}; edges dropped "
            f"by the caps {h['edges_dropped']}")
    log(f"[{tag}] test (mean of {OAG_TEST_BATCHES} batches) NDCG "
        f"{out['test_ndcg']:.4f}, MRR {out['test_mrr']:.4f}")
    hist = out["history"]
    if not hist or not all(np.isfinite(h["loss"]) for h in hist) or not (
            0 <= out["test_ndcg"] <= 1 and 0 <= out["test_mrr"] <= 1):
        raise AssertionError(f"[{tag}] training failed: {hist}")


def per_type_nodes(item, layout):
    """Live nodes per type of one batch."""
    mask = np.asarray(item.tb.sub.node_mask)
    return {t: int(mask[i].sum()) for i, t in enumerate(layout.schema.node_types)}


def card_against_cpu(tag, dev, model, loss_fn, args, n_layers,
                     outputs=None, expected=None):
    """``loss_fn(m, em_on_device)(None, *args(device))`` forward and
    backward with ``model``'s weights on the card and on the CPU (dropout
    0, TF32 off): the loss and the global gradient norm within CPU_TOL, and
    the launches of one train step on the card (``expected(counts)``, by
    default the HGT path's). ``outputs(m, device)``, when given, names
    tensors of the forward (its live rows) that must agree to CPU_TOL as
    max |card - CPU| over max |CPU|: a loss can sit at a value that does
    not depend on them. Returns the card's counts."""
    res, outs = {}, {}
    for role, device in (("card", dev), ("cpu", torch.device("cpu"))):
        m = model.to(device)
        for p in m.parameters():
            p.grad = None
        if role == "card":
            torch.cuda.synchronize()
            reset_counts()
        t0 = time.perf_counter()
        loss = loss_fn(m, device)(None, *args(device))
        loss.backward()
        # (DenseHGT's per-type norm parameters exist unused without
        # use_norm, as in the JAX package: no gradient)
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.float().norm() for p in m.parameters()
             if p.grad is not None])).item()
        res[role] = (loss.item(), norm, time.perf_counter() - t0)
        if role == "card":
            counts = read_counts()
        if outputs is not None:
            with torch.no_grad():
                outs[role] = {k: v.float().cpu()
                              for k, v in outputs(m, device).items()}
    (lg, ng, _), (lc, nc, tc) = res["card"], res["cpu"]
    want = (ogbn_expected(n_layers, 1, 0, counts) if expected is None
            else expected(counts))
    loss_err, norm_err = abs(lg - lc), abs(ng - nc) / max(nc, 1e-12)
    ok = (loss_err <= CPU_TOL and norm_err <= CPU_TOL and counts == want
          and np.isfinite([lg, ng]).all())
    out_text = ""
    for k, want_t in outs.get("cpu", {}).items():
        got_t = outs["card"][k]
        scale = want_t.abs().max().item()
        err = (got_t - want_t).abs().max().item() / max(scale, 1e-30)
        good = (got_t.shape == want_t.shape and scale > 0
                and bool(torch.isfinite(got_t).all()) and err <= CPU_TOL)
        ok = ok and good
        out_text += (f"; {k} {tuple(want_t.shape)}: max |card - CPU| over "
                     f"max |CPU| ({scale:.4g}) {err:.2e}"
                     f"{'' if good else ' FAIL'}")
    log(f"[{tag}] dropout 0, TF32 off: loss {lg:.5f} on the card against "
        f"{lc:.5f} on the CPU (|diff| {loss_err:.2e}), global gradient norm "
        f"{ng:.5f} against {nc:.5f} (relative {norm_err:.2e}){out_text} (tol "
        f"{CPU_TOL:g} each); CPU forward+backward {tc:.1f} s; launches of "
        f"one forward+backward {counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] the card and the CPU disagree")
    return counts


def prefilled_epoch(tag, dev, cfg, task, layout, em, pairs, in_dim,
                    profile, workdir):
    """The train steps' pace with the loader taken out: the runners' own
    epoch code (``_train_epoch``) over ``n_batch x repeat`` items that a
    PrefetchLoader made and copied to the card before the first step, on a
    fresh seeds-head model at ``cfg``, three times (the first warms).
    Prints the step by CUDA events and by the host clock; under
    ``--profile`` a fourth pass under torch.profiler gives the card's busy
    time over the same steps, and the idle share of the unprofiled step is
    1 - busy / step."""
    steps = cfg.n_batch * cfg.repeat
    model = node_classifier(cfg, layout, in_dim, task.n_classes, seed=3,
                            head_mode="seeds").to(dev)
    step = make_train_step(task.make_loss_fn(model, em.to(dev)),
                           make_tx(cfg, model.named_parameters(), steps))
    producer = _producer_for(
        cfg, task.make_sample_fn(pairs, OAG_SPLITS["train"]), layout, em)
    with _loader(producer, cfg, dev, {}) as loader:
        items = loader.take(steps)
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev)
    step_args = _label_step_args(dev, model)

    def epoch(i):
        t0 = time.perf_counter()
        loss, _, _, timing = _train_epoch(step, iter(items), cfg, i, gen,
                                          dev, step_args)
        if not np.isfinite(loss):
            raise AssertionError(f"[{tag}-prefilled] loss {loss}")
        return timing, (time.perf_counter() - t0) * 1e3 / steps

    runs = [epoch(i) for i in range(3)]
    for i, (timing, wall) in enumerate(runs):
        log(f"[{tag}-prefilled] pass {i}{' (warm-up)' if i == 0 else ''}: "
            f"{steps} steps on items already on the card: step "
            f"{timing['step_ms']:.2f} ms mean, {timing['step_ms_max']:.2f} "
            f"max (CUDA events, the {steps - 1} steps after the first); "
            f"{wall:.2f} ms per step by the host clock, the loss read "
            f"included; loader wait {timing['wait_ms']:.3f} ms/step")
    if profile:
        with profile_trace(str(workdir / f"{tag}_prefilled_trace")) as prof:
            epoch(3)
        busy, span = device_busy_share(prof, TRAIN_SPAN)
        step_ms = runs[-1][0]["step_ms"]
        log(f"[{tag}-prefilled-profile] the card busy {busy:.2f} ms of the "
            f"{steps} steps' {span:.2f} ms span under torch.profiler "
            f"({busy / steps:.2f} ms per step); against the unprofiled pass "
            f"2 step of {step_ms:.2f} ms: idle share "
            f"{1 - busy / steps / step_ms:.3f}")


def oag_item(cfg, graph, task, pairs, seeds_fn, seeds_bounded=True):
    """One producer item of ``task`` on ``pairs`` (the loader's path:
    sample, pad, the C++ sort with the backward's aux), on a layout
    calibrated from ``seeds_fn`` as the runner calibrates its own (the
    draws are unseeded, so the caps may differ a little; ``seeds_bounded``
    as ``make_layout`` takes it): returns (item, layout, em)."""
    layout = make_layout(cfg, graph, sampler=task.sampler, seeds_fn=seeds_fn,
                         seeds_bounded=seeds_bounded)
    task.layout = layout
    em = EdgeStaticMeta.from_layout(layout)
    item = _make_producer(task.make_sample_fn(pairs, OAG_SPLITS["train"]),
                          layout, em)(np.random.default_rng(12))
    return item, layout, em


def oag_field_item(cfg, graph):
    """One producer item of the paper-field task at ``cfg`` on a layout
    calibrated as its runner calibrates it (:func:`oag_item`): returns
    (item, layout, em, task, train pairs)."""
    task = NodeClassificationTask(
        graph=graph, sampler=make_sampler(cfg, graph, log=log), layout=None,
        target_type="paper", label_meta=OAG_FIELD_LABEL,
        batch_size=cfg.batch_size, feature_fn=feature_oag)
    pairs = build_time_split_pairs(graph, task.rev_label_meta,
                                   OAG_SPLITS)["train"]
    crng = np.random.default_rng(cfg.seed + 7)
    item, layout, em = oag_item(
        cfg, graph, task, pairs, lambda: task.build_seeds(pairs, crng)[0])
    return item, layout, em, task, pairs


def phase_path_kernels(tag, dev, se, cfg, softmax=True):
    """The kernels of a path held against their plain versions on one real
    batch of it at its widths (rows of n_hid, bf16 and f32, the runs aux on
    outputs whose memory held NaN; logits of n_heads), and timed in bf16
    beside their bounds: ``live_partials`` on the target aux, the pair and
    the slab on the src runs and tab-window aux, and unless ``softmax`` is
    false (a rank-capped target aux, which that kernel does not take) the
    softmax partials. ``tag``: ``oag``, ``ogbn`` or a ``tp_`` width.
    Returns a dict of record keys, prefixed with the tag, per kernel."""
    D, H = cfg.n_hid, cfg.n_heads
    gen = torch.Generator(device=dev).manual_seed(7)
    E = se.pseg_tgt.loc.size
    n_tiles, K = se.pseg_tgt.loc.shape
    pad = ~np.asarray(se.edge_mask).reshape(n_tiles, K)
    log(f"[{tag}] the batch: {E} padded edges in {n_tiles} tiles of {K}, "
        f"{int(pad.sum())} of them padding (share {pad.mean():.3f}); "
        f"{int(pad.all(axis=1).sum())} tiles all padding; every walk reads "
        "and sums them")
    b1 = torch.randn(E, D, generator=gen, device=dev)
    b2 = torch.randn(E, D, generator=gen, device=dev)
    out = {}

    def keys(shape, err, t):
        return {f"{tag}_shape": list(shape), f"{tag}_max_abs_err": err,
                f"{tag}_ms": t["ms"], f"{tag}_plain_ms": t["plain_ms"],
                f"{tag}_bound_ms": t["bound_ms"],
                f"{tag}_library_ms": t["library_ms"],
                **walk_keys(t, f"{tag}_")}

    gaux = se.pseg_tgt.to(dev)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        x = b1.to(dtype)
        err = max(err, check_walk(
            f"[{tag}] live_partials W={gaux.w} V={gaux.v} {str(dtype)[6:]} "
            f"{tuple(x.shape)}", lambda: live_partials(x, gaux),
            live_partials_plain(x, gaux), live_partials_plain(x.abs(), gaux),
            gaux, D))
    x = b1.bfloat16()
    rows = out_rows(gaux)
    zeros = torch.zeros(gaux.num_blocks * gaux.w, D, device=dev)
    x32 = x.float()
    bound, nbytes = bound_ms(x, gaux)
    t = time_walk(f"[{tag}] live_partials bf16 {tuple(x.shape)} W={gaux.w} "
                  f"V={gaux.v}", "live_partials",
                  lambda a: live_partials(a, gaux), [x], gaux,
                  lambda a: live_partials_plain(a, gaux),
                  lambda: torch.index_add(zeros, 0, rows, x32),
                  "index_add (f32 source)", nbytes, bound)
    out["live_partials"] = keys(x.shape, err, t)

    auxes = {"runs": ("src-runs", se.pseg_src)}
    if se.ptab_src is not None:
        auxes["window"] = ("tab-window", se.ptab_src)
    # the slab's contract takes 128-aligned halves (the OAG's D = 400 not)
    slab_fits = D % 128 == 0
    if not slab_fits:
        log(f"[{tag}] live_partials_slab takes 128-aligned halves: not run "
            f"at D = {D}")
    for kind, (name, aux) in auxes.items():
        gaux = aux.to(dev)
        err = slab_err = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            d1, d2 = b1.to(dtype), b2.to(dtype)
            err = max(err, check_walk(
                f"[{tag}] live_partials_pair {name} W={aux.w} V={aux.v} "
                f"{str(dtype)[6:]} {tuple(d1.shape)}",
                lambda: live_partials_pair(d1, d2, gaux),
                live_partials_pair_plain(d1, d2, gaux),
                live_partials_pair_plain(d1.abs(), d2.abs(), gaux), gaux, D))
            if not slab_fits:
                continue
            slab = torch.cat([d1, d2], dim=1)
            slab_err = max(slab_err, check_walk(
                f"[{tag}] live_partials_slab {name} W={aux.w} V={aux.v} "
                f"{str(dtype)[6:]} {tuple(slab.shape)}",
                lambda: ps.live_partials_slab(slab, gaux),
                ps.live_partials_slab_plain(slab, gaux),
                ps.live_partials_slab_plain(slab.abs(), gaux), gaux, D))
        d1, d2 = b1.bfloat16(), b2.bfloat16()
        f1, f2 = d1.float(), d2.float()
        rows = out_rows(gaux)
        zeros = torch.zeros(gaux.num_blocks * gaux.w, D, device=dev)
        bound, nbytes = bound_ms(d1, gaux, n_tensors=2)
        t = time_walk(
            f"[{tag}] live_partials_pair {name} bf16 2 x {tuple(d1.shape)} "
            f"W={gaux.w} V={gaux.v}", "live_partials_pair",
            lambda a, b: live_partials_pair(a, b, gaux), [d1, d2], gaux,
            lambda a, b: live_partials_pair_plain(a, b, gaux),
            lambda: (torch.index_add(zeros, 0, rows, f1),
                     torch.index_add(zeros, 0, rows, f2)),
            "two index_add (f32 sources)", nbytes, bound)
        out[f"pair_{kind}"] = keys(d1.shape, err, t)
        if slab_fits:
            slab = torch.cat([d1, d2], dim=1)
            t = time_slab(f"[{tag}] live_partials_slab {name}", slab, gaux)
            out[f"slab_{kind}"] = keys(slab.shape, slab_err, t)
    if not softmax:
        return out

    gaux = se.pseg_tgt.to(dev)
    att = torch.randn(E, H, generator=gen, device=dev) * 4
    mask = torch.as_tensor(se.edge_mask, device=dev)
    att = torch.where(mask[:, None], att, torch.full_like(att, -1e30))
    m, s = ps.segment_softmax_partials(att, gaux)
    pm, psum = ps.segment_softmax_partials_plain(att, gaux)
    torch.cuda.synchronize()
    m_equal = bool(torch.equal(m, pm))
    err = (s - psum).abs().max().item()
    ok = m_equal and bool(((s - psum).abs() <= 1e-5 * psum.abs()).all())
    log(f"[kernel] [{tag}] segment_softmax_partials W={gaux.w} att "
        f"{tuple(att.shape)} ({int((~mask).sum())} masked rows): max "
        f"bit-equal {m_equal}, sums max_abs_err {err:.3e} (tol 1e-5 x "
        f"|value|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] segment_softmax_partials disagrees "
                             "with its plain version")
    rows = out_rows(gaux)
    idx = rows[:, None].expand(-1, H)
    ex = torch.exp(torch.clamp(att - pm[rows], max=80.0))
    zeros = torch.zeros_like(pm)
    ms = cuda_ms(lambda: ps.segment_softmax_partials(att, gaux))
    plain_ms = cuda_ms(lambda: ps.segment_softmax_partials_plain(att, gaux))
    library_ms = cuda_ms(lambda: (
        torch.scatter_reduce(zeros, 0, idx, att, "amax", include_self=False),
        torch.index_add(zeros, 0, rows, ex)))
    nbytes = (att.numel() * 4 + gaux.loc.numel() * 4 + gaux.loc.shape[0] * 4
              + 2 * m.numel() * 4)
    bound = max(nbytes / HBM_BYTES_PER_S, 5 * att.numel() / F32_FLOPS) * 1e3
    time_line(f"[{tag}] segment_softmax_partials att {tuple(att.shape)} "
              f"W={gaux.w} (eager wrapper)", ms, nbytes, plain_ms,
              "scatter_reduce(amax) + index_add of ready exps", library_ms,
              bound)
    out["softmax"] = {f"{tag}_shape": list(att.shape),
                      f"{tag}_max_abs_err": err, f"{tag}_ms": ms,
                      f"{tag}_plain_ms": plain_ms, f"{tag}_bound_ms": bound,
                      f"{tag}_library_ms": library_ms}
    return out


def ogbn_item(graph):
    """One producer item of the ``[ogbn]`` path: the ``ogbn_mag`` preset
    with the slice's flags, its layout calibrated as ``run_ogbn``
    calibrates it, the loader's sample, pad and C++ sort with the
    backward's aux. Returns (item, layout, cfg)."""
    cfg = served_config()
    sampler = make_sampler(cfg, graph, log=lambda msg: None)
    crng = np.random.default_rng(cfg.seed + 7)
    years = np.asarray(graph.aux["years"]).reshape(-1)

    def cal_seeds():
        pick = crng.choice(len(years), min(cfg.batch_size, len(years)),
                           replace=False)
        return {"paper": np.stack([pick, years[pick]], axis=1)}

    layout = make_layout(cfg, graph, sampler=sampler, seeds_fn=cal_seeds)
    em = EdgeStaticMeta.from_layout(layout)
    task = OgbnNodeTask(graph=graph, sampler=sampler, layout=layout,
                        batch_size=cfg.batch_size)
    item = _make_producer(task.make_sample_fn("train"), layout, em)(
        np.random.default_rng(12))
    return item, layout, cfg


def phase_ogbn_kernels(dev, graph):
    """The walks and the softmax partials at the ``[ogbn]`` path's
    calibrated layout (D = 512), on one item of it."""
    item, layout, cfg = ogbn_item(graph)
    se = item.se
    log(f"[ogbn-kernels] one producer item on the calibrated layout (node "
        f"cap {layout.node_cap}, {layout.num_edges} padded edges = "
        f"{se.pseg_tgt.loc.shape[0]} tiles of {se.pseg_tgt.loc.shape[1]}): "
        f"{item.n_edges} valid edges; target aux W={se.pseg_tgt.w} "
        f"V={se.pseg_tgt.v}, tab aux "
        f"{'window' if se.ptab_src is not None else 'none'}")
    return phase_path_kernels("ogbn", dev, se, cfg)


def phase_hard_kernels(dev):
    """The walks on the hard layouts of ``sampling/seg_cases.py`` (a
    whole-tile run, runs across every block boundary, a row per run, rows
    that skip values, dead rows with all-dead tiles, the window at W = V =
    240), at 6, 72 and 138 tiles (a tile split over 8, 4 and 2 blocks on
    132 SMs), bf16 and f32, rows of 400 (the slab: halves of 384):
    ``live_partials`` on every runs case, the pair and the slab on all;
    each against its plain version, the runs aux on outputs whose memory
    held NaN. Then each wrapper's host time per call (eager on 6 tiles).
    Returns per kernel the largest error and the host floor."""
    D = 400
    DS = 384  # the slab's halves must be 128-aligned
    errs = {"live_partials": 0.0, "pair": 0.0, "slab": 0.0}
    splits = {}
    gen = torch.Generator(device=dev).manual_seed(11)
    for n_tiles in (6, 72, 138):
        for case, aux in adversarial_auxes(n_tiles).items():
            gaux = aux.to(dev)
            E = gaux.loc.numel()
            base = torch.randn(E, 2 * D, generator=gen, device=dev)
            for dtype in (torch.bfloat16, torch.float32):
                slab = base.to(dtype)
                d1, d2 = slab[:, :D].contiguous(), slab[:, D:].contiguous()
                what = f"[hard] {case} {n_tiles} tiles {str(dtype)[6:]}"
                if not aux.window:
                    errs["live_partials"] = max(errs["live_partials"], check_walk(
                        f"{what} live_partials", lambda: live_partials(d1, gaux),
                        live_partials_plain(d1, gaux),
                        live_partials_plain(d1.abs(), gaux), gaux, D))
                errs["pair"] = max(errs["pair"], check_walk(
                    f"{what} live_partials_pair",
                    lambda: live_partials_pair(d1, d2, gaux),
                    live_partials_pair_plain(d1, d2, gaux),
                    live_partials_pair_plain(d1.abs(), d2.abs(), gaux), gaux,
                    D))
                s2 = slab[:, :2 * DS].contiguous()
                errs["slab"] = max(errs["slab"], check_walk(
                    f"{what} live_partials_slab D={DS}",
                    lambda: ps.live_partials_slab(s2, gaux),
                    ps.live_partials_slab_plain(s2, gaux),
                    ps.live_partials_slab_plain(s2.abs(), gaux), gaux, DS))
            splits[(n_tiles, case)] = ps.walk_plan("live_partials_pair",
                                                   d1, gaux)["split"]
    log(f"[hard] every check passed; blocks per tile (S) by (tiles, case): "
        f"{ {f'{n}/{c}': v for (n, c), v in splits.items()} }; largest "
        f"errors {errs}")
    # the wrappers' host time per call, which bounds an eager loop from
    # below: eager calls on the smallest case (6 tiles), beside the same
    # calls' device time in a CUDA graph
    gaux = adversarial_auxes(6)["whole-tile"].to(dev)
    x = torch.randn(gaux.loc.numel(), 2 * DS, generator=gen,
                    device=dev).bfloat16()
    d1, d2 = x[:, :DS].contiguous(), x[:, DS:].contiguous()
    calls = {"live_partials": lambda: live_partials(d1, gaux),
             "pair": lambda: live_partials_pair(d1, d2, gaux),
             "slab": lambda: ps.live_partials_slab(x, gaux)}
    floors = {k: (cuda_ms(f, iters=200, warmup=20), graph_ms([f] * 8))
              for k, f in calls.items()}
    log("[hard] host floor (eager wrapper on 6 tiles of 384 rows of "
        f"{DS} bf16; its device time in a CUDA graph): " + ", ".join(
            f"{k} {e:.4f} ms ({g:.4f})" for k, (e, g) in floors.items())
        + f" | {card_line()}")
    return {k: dict(max_abs_err=v, host_floor_ms=floors[k][0],
                    floor_device_ms=floors[k][1]) for k, v in errs.items()}


def phase_oag_field(dev, graph, workdir, profile=False):
    """``run_node_classification`` at the paper_field preset's full width
    with the slice's flags and ``feature_oag`` (KL over the multi-hot L2
    fields): 1 epoch, its validation batch and 10 test batches, launches
    asserted; a resumed run of one more epoch (under ``--profile`` the
    card's busy time and the loader wait over its train steps); one
    producer item's loss, gradient norm, representations and log-probs
    against the CPU; the steps' pace on items already on the card
    (:func:`prefilled_epoch`, and under ``--profile`` the idle share at that
    pace); the three kernels at the path's widths on that item. Returns the
    launch counts and the kernels' records."""
    t_phase = time.perf_counter()
    cfg = oag_config("paper_field", workdir)
    steps = cfg.n_batch * cfg.repeat
    log(f"[oag-field] run_node_classification at the paper_field preset "
        f"(n_hid {cfg.n_hid}, {cfg.n_heads} heads, {cfg.n_layers} layers, "
        f"depth {cfg.sample_depth}, width {cfg.sample_width}, batch "
        f"{cfg.batch_size}, calibrated caps, n_pool {cfg.n_pool}) with "
        f"--seg_pallas --edge_bf16 --softmax_pallas --features oag on the "
        f"OAG proxy; cut in length only: n_epoch {cfg.n_epoch}, n_batch "
        f"{cfg.n_batch} x repeat {cfg.repeat}")
    logs = []

    def tee(msg):
        logs.append(msg)
        log(f"[oag-field]   {msg}")

    kw = dict(label_meta=OAG_FIELD_LABEL, multi_label=True,
              feature_fn=feature_oag, log=tee, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = run_node_classification(cfg, graph, **kw)
    counts = read_counts()
    log(f"[oag-field] run_node_classification in "
        f"{time.perf_counter() - t0:.1f} s; {layout_line(logs)}")
    epoch_lines("oag-field", out, cfg)
    oag_launches("oag-field", counts, cfg, steps * cfg.n_epoch,
                 cfg.n_epoch + OAG_TEST_BATCHES)

    logs.clear()
    resume = cfg.replace(n_epoch=cfg.n_epoch + 1)
    reset_counts()
    t0 = time.perf_counter()
    if profile:
        with profile_trace(str(workdir / "oag_field_trace")) as prof:
            again = run_node_classification(resume, graph, resume=True, **kw)
        busy, span = device_busy_share(prof, TRAIN_SPAN)
        h = again["history"][-1]
        wait = h["wait_ms"] * steps
        log(f"[oag-field-profile] resumed epoch under torch.profiler: the "
            f"card busy {busy:.1f} of the {steps} train steps' {span:.1f} ms "
            f"span ({busy / steps:.2f} ms per step): idle share "
            f"{1 - busy / span:.3f} under the profiler; of the span the "
            f"consumer waited {wait:.1f} ms on the loader (share "
            f"{wait / span:.3f}); the profiled step {h['step_ms']:.2f} ms "
            f"(CUDA events; the pace without the loader: "
            f"[oag-field-prefilled])")
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25))
    else:
        again = run_node_classification(resume, graph, resume=True, **kw)
    resumed = read_counts()
    epochs = [h["epoch"] for h in again["history"]]
    ok = epochs == [cfg.n_epoch] and any(
        "resumed" in m and f"at epoch {cfg.n_epoch}" in m for m in logs)
    log(f"[oag-field-resume] n_epoch {resume.n_epoch} with resume=True: "
        f"trained epochs {epochs} in {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[oag-field-resume] did not resume for one epoch")
    epoch_lines("oag-field-resume", again, cfg)
    oag_launches("oag-field-resume", resumed, cfg, steps,
                 1 + OAG_TEST_BATCHES)
    total = {k: counts[k] + resumed[k] for k in counts}

    c0 = cfg.replace(dropout=0.0)
    item, layout, em, task, pairs = oag_field_item(c0, graph)
    log(f"[oag-field-cpu] one producer item on a calibrated layout (node cap "
        f"{layout.node_cap}, {layout.num_edges} padded edges): "
        f"{item.n_edges} valid edges, {item.overflow} dropped, live nodes "
        f"per type {per_type_nodes(item, layout)}, labels "
        f"{tuple(item.tb.labels.shape)} over {task.n_classes} L2 fields")
    model = node_classifier(c0, layout, oag_in_dim(graph), task.n_classes,
                            seed=3, head_mode="seeds")
    tb = item.tb
    args = label_args(tb, item.se, model)

    live = torch.as_tensor(tb.sub.node_mask)
    seeds = torch.as_tensor(tb.label_mask)

    def outputs(m, d):
        a = args(d)[:3]
        return {"representations (live rows)":
                m.representations(*a, em.to(d))[live.to(d)],
                "log-probs (live seeds)": m(*a, em.to(d))[seeds.to(d)]}

    card_against_cpu("oag-field-cpu", dev, model,
                     lambda m, d: task.make_loss_fn(m, em.to(d)), args,
                     c0.n_layers, outputs)
    prefilled_epoch("oag-field", dev, cfg, task, layout, em, pairs,
                    oag_in_dim(graph), profile, workdir)
    kernels = phase_path_kernels("oag", dev, item.se, cfg)
    log(f"[oag-field] phase done in {time.perf_counter() - t_phase:.1f} s")
    return total, kernels


def phase_oag_venue(dev, workdir):
    """``python -m pyhgt_tpu_torch.run paper_venue`` in process on the
    proxy's save_dir with the slice's flags for one short epoch: the NLL
    head over the venues."""
    cfg = oag_config("paper_venue", workdir).replace(n_batch=2)
    argv = ["paper_venue", "--data", str(workdir / "oag_graph"),
            "--device", dev.type, "--model_dir", cfg.model_dir,
            "--n_epoch", "1", "--n_batch", str(cfg.n_batch), "--seg_pallas",
            "--edge_bf16", "--softmax_pallas"]
    t0 = time.perf_counter()
    rc, lines, counts = run_main(argv)
    for line in lines:
        if line.startswith(("layout:", "epoch", "test NDCG")):
            log(f"[oag-venue]   {line}")
    ok = (rc == 0 and any(l.startswith("epoch 0: loss") for l in lines)
          and (Path(cfg.model_dir) / "paper_venue_hgt" / "state.pt").exists())
    log(f"[oag-venue] run.main({' '.join(argv[:1] + argv[3:])}) exit "
        f"{rc} in {time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        log("\n".join(lines[-40:]))
        raise AssertionError("[oag-venue] paper_venue did not train")
    oag_launches("oag-venue", counts, cfg, cfg.n_batch * cfg.repeat,
                 1 + OAG_TEST_BATCHES)
    return counts


def phase_oag_link(dev, graph, workdir):
    """``run_author_disambiguation`` at its preset's full width with the
    slice's flags: 1 epoch, its validation batch and 10 test batches,
    launches asserted; one producer item's grouped loss, gradient norm,
    representations and ``score_pairs`` against the CPU (at initial weights
    the scores are near 0 and the loss near 1 whatever the
    representations, so the forward's outputs are compared on their own)."""
    t_phase = time.perf_counter()
    cfg = oag_config("author_disambiguation", workdir)
    steps = cfg.n_batch * cfg.repeat
    log(f"[oag-link] run_author_disambiguation at its preset (n_hid "
        f"{cfg.n_hid}, {cfg.n_heads} heads, {cfg.n_layers} layers, depth "
        f"{cfg.sample_depth}, width {cfg.sample_width}, batch "
        f"{cfg.batch_size} papers of {cfg.batch_size // 4} names, groups "
        f"padded to 32, calibrated caps) with --seg_pallas --edge_bf16 "
        f"--softmax_pallas; n_epoch {cfg.n_epoch}, n_batch {cfg.n_batch} x "
        f"repeat {cfg.repeat}")
    logs = []

    def tee(msg):
        logs.append(msg)
        log(f"[oag-link]   {msg}")

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = run_author_disambiguation(cfg, graph, log=tee, device=dev)
    counts = read_counts()
    log(f"[oag-link] run_author_disambiguation in "
        f"{time.perf_counter() - t0:.1f} s; {layout_line(logs)}")
    epoch_lines("oag-link", out, cfg)
    oag_launches("oag-link", counts, cfg, steps * cfg.n_epoch,
                 cfg.n_epoch + OAG_TEST_BATCHES)
    best = Path(cfg.model_dir) / "author_disambiguation_hgt"
    if not (best / "state.pt").exists():
        raise AssertionError("[oag-link] no best checkpoint")

    c0 = cfg.replace(dropout=0.0)
    groups = build_name_groups(graph)
    pairs = build_link_pairs(graph, groups, OAG_SPLITS)
    task = LinkPredictionTask(graph=graph,
                              sampler=make_sampler(c0, graph, log=log),
                              layout=None, groups=groups,
                              batch_size=c0.batch_size)
    crng = np.random.default_rng(c0.seed + 7)
    item, layout, em = oag_item(
        c0, graph, task, pairs["train"], lambda: task.build_seeds(
            pairs["train"], OAG_SPLITS["train"], crng)[0],
        seeds_bounded=False)
    tb = item.tb
    log(f"[oag-link-cpu] one producer item on a calibrated layout (node cap "
        f"{layout.node_cap}, {layout.num_edges} padded edges): "
        f"{item.n_edges} valid edges, {item.overflow} dropped, "
        f"{int(tb.query_mask.sum())} live query papers, "
        f"{int(tb.cand_mask.sum())} candidates; live nodes per type "
        f"{per_type_nodes(item, layout)}")
    model = link_matcher(c0, layout, tb.sub.node_feat.shape[-1], seed=3)

    def args(device):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return (t(tb.sub.node_feat), t(tb.sub.node_mask), item.se.to(device),
                t(tb.cand_idx), t(tb.cand_mask), t(tb.query_mask).float())

    live = torch.as_tensor(tb.sub.node_mask)
    pair_live = torch.as_tensor(tb.query_mask[:, None] & tb.cand_mask)

    def outputs(m, d):
        a = args(d)
        return {"representations (live rows)":
                m.gnn(*a[:3], em.to(d))[live.to(d)],
                "score_pairs (live pairs)":
                m.score_pairs(*a[:3], em.to(d), a[3])[pair_live.to(d)]}

    card_against_cpu("oag-link-cpu", dev, model,
                     lambda m, d: make_link_loss_fn(m, em.to(d)), args,
                     c0.n_layers, outputs)
    log(f"[oag-link] phase done in {time.perf_counter() - t_phase:.1f} s")
    return counts, str(best)


def phase_link_serve(dev, graph, ckpt, workdir):
    """A LinkPredictor restored from [oag-link]'s best checkpoint: the
    index over 2,048 grouped authors, then 8 JSON-lines requests of 1-256
    papers through ``serve_link_jsonl`` one at a time after a warm-up,
    timed by part; the top-k against a plain float64 recomputation of the
    index product; launches per forward asserted."""
    cfg = oag_config("author_disambiguation", workdir)
    t0 = time.perf_counter()
    pred = LinkPredictor(cfg, graph, ckpt, log=lambda s: None, device=dev)
    log(f"[link-serve] LinkPredictor on {dev} in "
        f"{time.perf_counter() - t0:.2f} s: layout node cap "
        f"{pred.layout.node_cap}, {pred.layout.num_edges} padded edges")
    authors = sorted(a for g in pred.task.groups.values() for a in g)
    authors = authors[:LINK_INDEX_AUTHORS]
    torch.cuda.synchronize()
    reset_counts()
    pred.stats.clear()
    t0 = time.perf_counter()
    pred.build_author_index(authors)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    chunks = list(pred.stats)
    index_counts = read_counts()
    log(f"[link-serve] index of {len(authors)} authors in {len(chunks)} "
        f"chunks of {cfg.batch_size}: {build_ms:.1f} ms ({build_ms / len(chunks):.1f}"
        f" ms per chunk; sampler {np.mean([c['sample_ms'] for c in chunks]):.2f}"
        f", host sort {np.mean([c['sort_ms'] for c in chunks]):.2f}, forward "
        f"{np.mean([c['forward_ms'] for c in chunks]):.2f} ms per chunk, "
        f"mean); index {tuple(pred.index._emb.shape)} version "
        f"{pred.index.params_version}")
    want = scaled(PREDICTOR_FORWARD, cfg.n_layers * len(chunks))
    if index_counts != want:
        raise AssertionError(f"[link-serve] index launches {index_counts} != "
                             f"{want}")

    rng = np.random.default_rng(44)
    n_paper = graph.num_nodes["paper"]

    def serve_one(n):
        req = {"papers": rng.choice(n_paper, n, replace=False).tolist(),
               "k": LINK_K}
        out = io.StringIO()
        t0 = time.perf_counter()
        served = serve_link_jsonl(pred, stdin=io.StringIO(json.dumps(req)
                                                          + "\n"),
                                  stdout=out, log=lambda s: None)
        ms = (time.perf_counter() - t0) * 1e3
        resp = json.loads(out.getvalue())
        if served != 1 or "error" in resp:
            raise AssertionError(f"request failed: {resp.get('error')}")
        return req, resp, ms

    serve_one(LINK_REQUESTS[-1])                  # warm-up
    torch.cuda.synchronize()
    pred.stats.clear()
    reset_counts()
    rows = []
    for n in LINK_REQUESTS:
        req, resp, total = serve_one(n)
        (st,) = pred.stats[len(rows):]
        vals, ids = np.asarray(resp["scores"]), np.asarray(resp["authors"])
        ok = (resp["papers"] == req["papers"] and vals.shape == ids.shape
              == (n, LINK_K) and bool(np.isfinite(vals).all())
              and bool((np.diff(vals, axis=1) <= 0).all())
              and set(ids.ravel().tolist()) <= set(authors))
        rows.append(dict(st, total_ms=total, papers=n, req=req, resp=resp))
        log(f"[link-serve] request {len(rows)}: {n} papers, top {LINK_K} | "
            f"sampler {st['sample_ms']:.2f} ms, host sort {st['sort_ms']:.2f} "
            f"ms, forward {st['forward_ms']:.2f} ms, score + top-k "
            f"{st['topk_ms']:.2f} ms, total {total:.2f} ms | valid edges "
            f"{st['edges']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[link-serve] request {len(rows)}: bad "
                                 "answer")
    counts = read_counts()
    for key in ("sample_ms", "sort_ms", "forward_ms", "topk_ms", "total_ms"):
        vals = [r[key] for r in rows]
        log(f"[link-serve] {key} per request over {len(rows)}: mean "
            f"{np.mean(vals):.2f}, max {np.max(vals):.2f}")
    want = scaled(PREDICTOR_FORWARD, cfg.n_layers * len(rows))
    log(f"[link-serve] kernel launches {counts} over {len(rows)} forwards "
        f"(expected per layer and forward {PREDICTOR_FORWARD})")
    if counts != want:
        raise AssertionError("[link-serve] the launches differ")

    # the top-k against the index product recomputed in float64 on the
    # host, from the same query representations (the request's sampler
    # draw is the default generator's): compared by score, so that ties
    # may come in any order
    emb = pred.index._emb.double().cpu()
    p_ti = pred.layout.schema.type_id("paper")
    worst = 0.0
    for r in rows:
        papers = np.asarray(r["req"]["papers"])
        seeds = {"paper": np.stack([papers, np.full(len(papers),
                                                    pred.max_time)], 1)}
        h = pred._reps(seeds, np.random.default_rng(cfg.seed + 13))
        with torch.inference_mode():
            q = pred.model.matcher.right(h[p_ti, : len(papers)])
        full = (q.double().cpu() @ emb.T / np.sqrt(cfg.n_hid)).numpy()
        top = -np.sort(-full, axis=1)[:, :LINK_K]
        vals = np.asarray(r["resp"]["scores"])
        pos = np.searchsorted(pred.index._cand_ids,
                              np.asarray(r["resp"]["authors"]))
        picked = np.take_along_axis(full, pos, axis=1)
        tol = 1e-4 + 1e-4 * np.abs(top)
        worst = max(worst, float(np.abs(vals - top).max()),
                    float(np.abs(picked - top).max()))
        if not ((np.abs(vals - top) <= tol).all()
                and (np.abs(picked - top) <= tol).all()):
            raise AssertionError("[link-serve] top-k differs from the plain "
                                 "index product")
    log(f"[link-serve] top-{LINK_K} scores and the picked authors' scores "
        f"against the float64 recomputation of the index product: max |diff| "
        f"{worst:.3e} (tol 1e-4 + 1e-4 x |score|; TF32 off) ok")
    return index_counts, counts


def phase_profile(fl, batch, labels, pred):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ids = np.random.default_rng(3).choice(pred.task.graph.num_nodes["paper"],
                                          128, replace=False)
    pred.predict_logprobs(ids, vr_num=1, rng=np.random.default_rng(4))
    torch.cuda.synchronize()
    pred.stats.clear()
    with profile(activities=acts) as prof:
        pred.predict_logprobs(ids, vr_num=1, rng=np.random.default_rng(4))
        torch.cuda.synchronize()
    st = pred.stats[0]
    log(f"[profile] one predictor request (128 nodes, vr_num 1, one forward) "
        f"under the profiler: sampler {st['sample_ms']:.2f} ms, host sort "
        f"{st['sort_ms']:.2f} ms, forward {st['forward_ms']:.2f} ms, "
        f"{st['edges']} valid edges:")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))
    se = fl.sort(batch)
    fl.forward(batch, se)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fl.forward(batch, se)
        torch.cuda.synchronize()
    log("[profile] one forward (serving):")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))

    args = fl.to_device(batch, se, labels)
    _, step = make_flagship_trainer(fl)
    step(*args)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        step(*args)
        torch.cuda.synchronize()
    log("[profile] one train step:")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))

    fl_slab = build_flagship("bench", device=fl.device, seed=0,
                             **CONFIGS["A"]["overrides"])
    args = fl_slab.to_device(batch, fl_slab.sort(batch), labels)
    _, step = make_flagship_trainer(fl_slab)
    step(*args)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        step(*args)
        torch.cuda.synchronize()
    log('[profile] one train step under edge_bwd="slab":')
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))

    fl_c = build_flagship("bench", device=fl.device, seed=0,
                          **CONFIGS["C"]["overrides"])
    se = fl_c.sort(batch, with_backward=False)
    fl_c.forward(batch, se)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fl_c.forward(batch, se)
        torch.cuda.synchronize()
    log("[profile] one forward under seg_rank_cap=0, softmax_pallas=True:")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))

    gaux = se.pseg_tgt.to(fl.device)
    att = torch.randn(gaux.loc.numel(), fl_c.cfg.n_heads, device=fl.device)
    ps.segment_softmax_partials(att, gaux)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        ps.segment_softmax_partials(att, gaux)
        torch.cuda.synchronize()
    log("[profile] one segment_softmax_partials call (every device op it "
        "issues):")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=10))


# the [convs] phase: every conv of the JAX package but HGT (which the phases
# above run) at the paper_field preset's full width with the slice's flags,
# through the runner's normal entry, each cut to 2 train steps (n_batch 1 x
# repeat 2), its validation batch and the runner's 10 test batches
NEW_CONVS = ("dense_hgt", "gcn", "gat", "rgcn", "han", "hetgnn")
CONV_CUTS = dict(n_epoch=1, n_batch=1)


def sorted_path(cfg):
    """Whether ``cfg``'s conv runs the sorted edge path, and its kernels
    (HGT and DenseHGT there; the segment path and the baselines reduce
    with ``index_add_`` and ``scatter_reduce``)."""
    return cfg.conv_name in SORTED_CONVS and cfg.edge_impl == "sorted"


def conv_expected(cfg, steps, forwards, counts):
    """The launches of ``steps`` train steps and ``forwards`` forwards of
    ``cfg``'s conv: the HGT path's on the sorted edge path, else none."""
    if sorted_path(cfg):
        return ogbn_expected(cfg.n_layers, steps, forwards, counts)
    return dict(NO_LAUNCH)


def label_args(tb, se, model):
    """``args(device)`` of a labelled item for :func:`card_against_cpu`:
    the loss closure's arguments, the raw edges last for a model that
    reads them."""
    def args(device):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return (t(tb.sub.node_feat), t(tb.sub.node_mask), se.to(device),
                t(tb.labels), t(tb.label_mask),
                raw_edges(model, tb.sub, device))
    return args


def conv_run(tag, cfg, graph, dev):
    """``run_node_classification`` of ``cfg`` on ``graph`` (KL over the
    multi-hot L2 fields, ``feature_oag``): its epoch line with the peak
    memory, launches asserted. Returns (counts, history record)."""
    steps = cfg.n_batch * cfg.repeat
    logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = run_node_classification(
        cfg, graph, label_meta=OAG_FIELD_LABEL, multi_label=True,
        feature_fn=feature_oag, log=logs.append, device=dev)
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    (h,) = out["history"]
    forwards = 1 + OAG_TEST_BATCHES
    want = conv_expected(cfg, steps, forwards, counts)
    ok = (bool(np.isfinite(h["loss"])) and counts == want
          and (not sorted_path(cfg)
               or counts["pair_runs"] >= cfg.n_layers * steps)
          and 0 <= out["test_ndcg"] <= 1)
    log(f"[{tag}] conv_name {cfg.conv_name}, edge_impl {cfg.edge_impl}: "
        f"run_node_classification in {secs:.1f} s; {layout_line(logs)}; "
        f"{steps} steps: loss {h['loss']:.4f}, step {h['step_ms']:.2f} ms "
        f"(CUDA events, the step after the first, same item), loader wait "
        f"{h['wait_ms']:.2f} ms/step, peak memory {peak:.2f} GiB; valid "
        f"NDCG {h['valid_ndcg']:.4f}, test NDCG {out['test_ndcg']:.4f}; "
        f"launches over {steps} steps and {forwards} forwards {counts} "
        f"(expected {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        log("\n".join(logs[-20:]))
        raise AssertionError(f"[{tag}] {cfg.conv_name} failed")
    return counts, h


def phase_convs(dev, graph, workdir):
    """Each conv of :data:`NEW_CONVS` trained by ``run_node_classification``
    at the paper_field preset's full width (:func:`conv_run`), its steps'
    pace on items already on the card (:func:`prefilled_epoch`: 8 steps,
    no loader wait, which the runner's 2 steps hold), then one producer
    item's loss and gradient norm on the card against the CPU's plain path
    (dropout 0, TF32 off). Returns DenseHGT's launches, the sorted path's
    kernels under another update half."""
    t_phase = time.perf_counter()
    base = oag_config("paper_field", workdir).replace(**CONV_CUTS)
    log(f"[convs] the paper_field preset (n_hid {base.n_hid}, "
        f"{base.n_heads} heads, {base.n_layers} layers, depth "
        f"{base.sample_depth}, width {base.sample_width}, batch "
        f"{base.batch_size}) with --seg_pallas --edge_bf16 --softmax_pallas "
        f"for each of {', '.join(NEW_CONVS)}: n_epoch {base.n_epoch}, "
        f"n_batch {base.n_batch} x repeat {base.repeat}")
    c0 = base.replace(dropout=0.0)
    item, layout, em, task, pairs = oag_field_item(c0, graph)
    dense = None
    for conv in NEW_CONVS:
        cfg = base.replace(conv_name=conv,
                           model_dir=str(workdir / f"convs_{conv}"))
        counts, _ = conv_run("convs", cfg, graph, dev)
        if conv == "dense_hgt":
            dense = counts
        prefilled_epoch(f"convs-{conv}", dev,
                        oag_config("paper_field", workdir).replace(
                            conv_name=conv),
                        task, layout, em, pairs, oag_in_dim(graph), False,
                        workdir)
        model = node_classifier(c0.replace(conv_name=conv), layout,
                                oag_in_dim(graph), task.n_classes, seed=3,
                                head_mode="seeds")
        card_against_cpu(
            f"convs-{conv}-cpu", dev, model,
            lambda m, d: task.make_loss_fn(m, em.to(d)),
            label_args(item.tb, item.se, model), c0.n_layers,
            expected=lambda counts, c=c0.replace(conv_name=conv):
                conv_expected(c, 1, 0, counts))
    log(f"[convs] phase done in {time.perf_counter() - t_phase:.1f} s")
    return dense


def phase_segment(dev, graph, workdir):
    """HGT on the segment edge path (``--edge_impl segment``) at the
    paper_field preset's full width: 2 train steps through the runner, no
    kernel launched, and the steps' pace on items already on the card
    (:func:`prefilled_epoch`); then one producer item's loss on the segment
    path against the sorted path's (the slice's flags) on the same
    weights, dropout 0."""
    t_phase = time.perf_counter()
    cfg = oag_config("paper_field", workdir).replace(
        **CONV_CUTS, edge_impl="segment",
        model_dir=str(workdir / "segment"))
    conv_run("segment", cfg, graph, dev)
    c0 = cfg.replace(dropout=0.0)
    item, layout, em, task, pairs = oag_field_item(c0, graph)
    prefilled_epoch("segment", dev, oag_config("paper_field", workdir).replace(
        edge_impl="segment"), task, layout, em, pairs, oag_in_dim(graph),
        False, workdir)
    losses, weights = {}, {}
    for impl in ("segment", "sorted"):
        model = node_classifier(c0.replace(edge_impl=impl), layout,
                                oag_in_dim(graph), task.n_classes, seed=3,
                                head_mode="seeds").to(dev)
        weights[impl] = model.state_dict()
        reset_counts()
        with torch.no_grad():
            loss = task.make_loss_fn(model, em.to(dev))(
                None, *label_args(item.tb, item.se, model)(dev))
        losses[impl] = (loss.item(), read_counts())
    same = all(torch.equal(v, weights["sorted"][k])
               for k, v in weights["segment"].items())
    (ls, cs), (lo, co) = losses["segment"], losses["sorted"]
    ok = (same and abs(ls - lo) <= CPU_TOL and np.isfinite(ls)
          and cs == NO_LAUNCH and co == ogbn_expected(c0.n_layers, 0, 1, co))
    log(f"[segment] one item, the same weights, dropout 0: loss {ls:.5f} on "
        f"the segment path (f32, launches {cs}) against {lo:.5f} on the "
        f"sorted path (bf16 edge stage, kernels: {co}); |diff| "
        f"{abs(ls - lo):.2e} (tol {CPU_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[segment] the edge paths disagree")
    log(f"[segment] phase done in {time.perf_counter() - t_phase:.1f} s")


# [dense-hgt-ogbn]: the ogbn_mag CLI with DenseHGT, cut in length only (the
# preset's 100 epochs of 32 x 2, the test split at vr_num 8: here 2 epochs
# of 3 x 2, the second's steps to set beside [ogbn]'s); then served
DENSE_OGBN_ARGS = ["--n_epoch", "2", "--n_batch", "3", "--vr_num", "1"]
DENSE_SERVE_REQUESTS = [1, 16, 128]


def run_main(argv, stdin_text=None):
    """``run.main(argv)`` in process with its stdout captured (and
    ``stdin_text`` as its stdin): returns (exit code, stdout lines,
    launches)."""
    buf = io.StringIO()
    old = sys.stdin
    torch.cuda.synchronize()
    reset_counts()
    try:
        if stdin_text is not None:
            sys.stdin = io.StringIO(stdin_text)
        with contextlib.redirect_stdout(buf):
            rc = run_cli.main(argv)
    finally:
        sys.stdin = old
    return rc, buf.getvalue().splitlines(), read_counts()


def phase_dense_hgt_ogbn(dev, graph, workdir):
    """``python -m pyhgt_tpu_torch.run ogbn_mag --conv_name dense_hgt
    --seg_pallas --edge_bf16 --softmax_pallas`` in process on the ogbn-mag
    proxy's save_dir, launches per step and per forward asserted, then
    ``run serve`` of its best checkpoint answering 3 requests, launches
    asserted. Returns the launches of both runs."""
    t_phase = time.perf_counter()
    model_dir = workdir / "dense_ogbn"
    data = str(workdir / "graph")
    flags = ["--device", dev.type, "--conv_name", "dense_hgt",
             "--seg_pallas", "--edge_bf16", "--softmax_pallas"]
    argv = ["ogbn_mag", "--data", data, "--model_dir", str(model_dir),
            *flags, *DENSE_OGBN_ARGS]
    cfg = served_config().replace(conv_name="dense_hgt", n_epoch=2,
                                  n_batch=3, vr_num=1)
    t0 = time.perf_counter()
    rc, lines, counts = run_main(argv)
    secs = time.perf_counter() - t0
    for line in lines:
        if line.startswith(("layout:", "epoch", "test acc")):
            log(f"[dense-hgt-ogbn]   {line}")
    recs = [json.loads(l) for l in
            (model_dir / "ogbn_mag_metrics.jsonl").read_text().splitlines()]
    hist = [r for r in recs if r.get("event") == "epoch"]
    epoch_steps = cfg.n_batch * cfg.repeat
    steps = epoch_steps * cfg.n_epoch
    n_test = int(np.asarray(graph.aux["test_mask"]).sum())
    n_valid = 4 * cfg.n_epoch
    forwards = n_valid + -(-n_test // cfg.batch_size) * cfg.vr_num
    want = ogbn_expected(cfg.n_layers, steps, forwards, counts)
    best = model_dir / "ogbn_mag_dense_hgt"
    ok = (rc == 0 and counts == want and len(hist) == cfg.n_epoch
          and all(np.isfinite(h["loss"]) for h in hist)
          and counts["pair_runs"] >= cfg.n_layers * steps
          and (best / "state.pt").exists())
    for h in hist:
        log(f"[dense-hgt-ogbn] epoch {h['epoch']}: loss {h['loss']:.4f}, step "
            f"{h['step_ms']:.2f} ms mean, {h['step_ms_max']:.2f} max (the "
            f"{epoch_steps - 1} steps after the epoch's first, by CUDA "
            f"events), loader wait {h['wait_ms']:.2f} ms/step, "
            f"{h['edges_per_s']:.6g} train edges/s")
    log(f"[dense-hgt-ogbn] run.main({' '.join(argv[:1] + argv[3:])}) exit "
        f"{rc} in {secs:.1f} s; launches over {steps} steps and {forwards} "
        f"forwards ({n_valid} validation, {forwards - n_valid} VR over "
        f"{n_test} test papers) {counts} (expected {want}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        log("\n".join(lines[-40:]))
        raise AssertionError("[dense-hgt-ogbn] the DenseHGT run failed")

    rng = np.random.default_rng(45)
    reqs = [{"nodes": rng.choice(graph.num_nodes["paper"], n,
                                 replace=False).tolist(), "vr_num": 1}
            for n in DENSE_SERVE_REQUESTS]
    t0 = time.perf_counter()
    rc, lines, served = run_main(
        ["serve", "--data", data, "--ckpt", str(best), *flags],
        "".join(json.dumps(r) + "\n" for r in reqs))
    secs = time.perf_counter() - t0
    n_fwd = sum(-(-len(r["nodes"]) // cfg.batch_size) for r in reqs)
    want_s = scaled(PREDICTOR_FORWARD, cfg.n_layers * n_fwd)
    answers = [json.loads(l) for l in lines]
    ok = (rc == 0 and served == want_s and len(answers) == len(reqs)
          and all(a["nodes"] == r["nodes"] and len(a["pred"]) == len(r["nodes"])
                  and all(0 <= c < 349 for c in a["pred"])
                  for a, r in zip(answers, reqs)))
    log(f"[dense-hgt-ogbn-serve] run serve --ckpt {best.name} --conv_name "
        f"dense_hgt: {len(answers)} answers to requests of "
        f"{DENSE_SERVE_REQUESTS} papers in {secs:.1f} s with the predictor's "
        f"build; launches over {n_fwd} forwards {served} (expected {want_s}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[dense-hgt-ogbn-serve] the checkpoint did not "
                             "serve")
    log(f"[dense-hgt-ogbn] phase done in {time.perf_counter() - t_phase:.1f} s")
    return {k: counts[k] + served[k] for k in NO_LAUNCH}


# [preprocess-oag]: synthetic OAG TSVs in the reference layout
# (pyhgt_tpu_torch/datasets/oag.py) from a seed; papers over 2000-2019,
# most of them cited enough to pass the filter
PRE_PAPERS, PRE_AUTHORS, PRE_AFFILS, PRE_VENUES = 12_000, 6_000, 300, 200
PRE_L1, PRE_L2 = 20, 200
PRE_MIN_PAPERS = 10_000


def write_oag_tsvs(d: Path, seed=0) -> None:
    """``Papers_CS``, ``PR_CS``, ``PF_CS``, ``FHierarchy``, ``PAuAf_CS``,
    ``vfi_vector`` and ``SeqName_CS`` (suffix ``_20190919.tsv``) in
    ``d``: a field hierarchy of L1 and L2 fields, venues of two types,
    authors with affiliations and positions, citations from newer papers
    and from outside the set, 400-wide pretrained vectors for the venues,
    fields and affiliations, and names."""
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True)
    sfx = "_CS_20190919.tsv"

    def write(name, rows, header=True):
        with open(d / name, "w") as f:
            if header:
                f.write("h\t" * 6 + "\n")
            f.writelines("\t".join(map(str, r)) + "\n" for r in rows)

    years = rng.integers(2000, 2020, PRE_PAPERS)
    venue_type = rng.choice(["Journal", "Conference"], PRE_VENUES)
    venue = rng.integers(0, PRE_VENUES, PRE_PAPERS)
    lang = np.where(rng.random(PRE_PAPERS) < 0.97, "en", "zh")
    write(f"Papers{sfx}", (
        [f"p{i}", years[i], f"title of paper {i}", f"v{venue[i]}", lang[i],
         "x", venue_type[venue[i]], "t"] for i in range(PRE_PAPERS)))
    by_year = np.argsort(years, kind="stable")
    cites = []
    for i in range(PRE_PAPERS):
        # the filter's bar, min(2020 - year, 20); 3% fall one short of it
        need = min(2020 - int(years[i]), 20)
        n = need - 1 if rng.random() < 0.03 else need + int(rng.integers(0, 3))
        newer = by_year[np.searchsorted(years[by_year], years[i]):]
        newer = newer[newer != i]
        k = min(n, 3, len(newer))
        cites += [[f"p{j}", f"p{i}"] for j in rng.choice(newer, k)]
        cites += [[f"e{i}_{j}", f"p{i}"] for j in range(n - k)]
    write(f"PR{sfx}", cites)
    l2_parent = rng.integers(0, PRE_L1, PRE_L2)
    write("FHierarchy_20190919.tsv",
          ([f"f2_{j}", f"f1_{l2_parent[j]}", "L2", "L1"]
           for j in range(PRE_L2)))
    pf = []
    for i in range(PRE_PAPERS):
        l2 = rng.choice(PRE_L2, int(rng.integers(1, 3)), replace=False)
        pf += [[f"p{i}", f"f2_{j}"] for j in l2]
        pf.append([f"p{i}", f"f1_{l2_parent[l2[0]]}"])
    write(f"PF{sfx}", pf)
    affil = rng.integers(0, PRE_AFFILS, PRE_AUTHORS)
    pa = []
    for i in range(PRE_PAPERS):
        for pos, a in enumerate(rng.choice(PRE_AUTHORS,
                                           int(rng.integers(1, 5)),
                                           replace=False), start=1):
            pa.append([f"p{i}", f"a{a}", f"af{affil[a]}", "x", pos])
    write(f"PAuAf{sfx}", pa)
    ids = ([f"v{j}" for j in range(PRE_VENUES)]
           + [f"f1_{j}" for j in range(PRE_L1)]
           + [f"f2_{j}" for j in range(PRE_L2)]
           + [f"af{j}" for j in range(PRE_AFFILS)])
    vecs = rng.normal(size=(len(ids), 400)).round(3)
    write("vfi_vector.tsv", ([i, " ".join(map(str, v))]
                             for i, v in zip(ids, vecs)), header=False)
    write(f"SeqName{sfx}", (
        [[f"v{j}", f"venue {j}", venue_type[j].lower()]
         for j in range(PRE_VENUES)]
        + [[f"f1_{j}", f"field {j}", "fos"] for j in range(PRE_L1)]
        + [[f"f2_{j}", f"subfield {j}", "fos"] for j in range(PRE_L2)]
        + [[f"a{j}", f"author {j}", "author"] for j in range(PRE_AUTHORS)]
        + [[f"af{j}", f"institute {j}", "affiliation"]
           for j in range(PRE_AFFILS)]), header=False)


def phase_preprocess_oag(dev, workdir):
    """``run preprocess_oag`` on synthetic TSVs (:func:`write_oag_tsvs`),
    the graph's node and edge counts by type, then ``run paper_field
    --data <output_dir>`` for 2 steps on the card at the preset's full
    width with the slice's flags, launches asserted."""
    t_phase = time.perf_counter()
    raw, out = workdir / "oag_raw", workdir / "oag_pre"
    t0 = time.perf_counter()
    write_oag_tsvs(raw)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc, lines, _ = run_main(["preprocess_oag", "--input_dir", str(raw),
                             "--output_dir", str(out), "--domain", "_CS"])
    pre_s = time.perf_counter() - t0
    g = run_cli.load_graph(str(out))
    edges = {"/".join(m): a.nnz for m, a in g.adj.items()}
    ok = (rc == 0 and g.num_nodes["paper"] >= PRE_MIN_PAPERS
          and any(m[2] == "PF_in_L2" for m in g.adj))
    log(f"[preprocess-oag] TSVs of {PRE_PAPERS} papers written in "
        f"{write_s:.1f} s; run preprocess_oag (host, stub title embeddings) "
        f"exit {rc} in {pre_s:.1f} s; nodes by type {g.num_nodes}; edges by "
        f"relation {edges} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[preprocess-oag] the graph was not built")
    cfg = oag_config("paper_field", workdir).replace(
        n_epoch=1, n_batch=1, model_dir=str(workdir / "pre_field"))
    argv = ["paper_field", "--data", str(out), "--device", dev.type,
            "--model_dir", cfg.model_dir, "--n_epoch", "1", "--n_batch", "1",
            "--seg_pallas", "--edge_bf16", "--softmax_pallas"]
    t0 = time.perf_counter()
    rc, lines, counts = run_main(argv)
    for line in lines:
        if line.startswith(("layout:", "epoch", "test NDCG")):
            log(f"[preprocess-oag]   {line}")
    ok = rc == 0 and any(l.startswith("epoch 0: loss") for l in lines)
    log(f"[preprocess-oag] run.main({' '.join(argv[:1] + argv[3:])}) on the "
        f"built graph exit {rc} in {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        log("\n".join(lines[-40:]))
        raise AssertionError("[preprocess-oag] paper_field did not train")
    oag_launches("preprocess-oag", counts, cfg, cfg.n_batch * cfg.repeat,
                 1 + OAG_TEST_BATCHES)
    log(f"[preprocess-oag] phase done in {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_convert(workdir):
    """A graph pickled as the reference pickles it (a ``GPT_GNN.data.Graph``
    object, as ``tests/test_datasets.py`` builds one) read by ``run``'s
    ``load_graph``, which falls back to the converter; then one sample."""
    import types

    class Graph:
        pass

    ref = Graph()
    ref.node_forward = {"paper": {f"p{i}": i for i in range(4)},
                        "venue": {"v0": 0}}
    ref.node_bacward = {
        "paper": [{"id": f"p{i}", "type": "paper"} for i in range(4)],
        "venue": [{"id": "v0", "type": "venue"}]}
    ref.edge_list = {
        "venue": {"paper": {"PV_in": {0: {0: 2010, 1: 2011}}}},
        "paper": {"venue": {"rev_PV_in": {0: {0: 2010}, 1: {0: 2011}}}}}
    ref.times = {2010: True, 2011: True}
    ref.node_feature = {"paper": {"emb": np.ones((4, 3), np.float32)},
                        "venue": {"emb": np.zeros((1, 3), np.float32)}}
    Graph.__module__, Graph.__qualname__ = "GPT_GNN.data", "Graph"
    mods = {"GPT_GNN": types.ModuleType("GPT_GNN"),
            "GPT_GNN.data": types.ModuleType("GPT_GNN.data")}
    mods["GPT_GNN.data"].Graph = Graph
    path = workdir / "reference_graph.pk"
    sys.modules.update(mods)
    try:
        with open(path, "wb") as f:
            pickle.dump(ref, f)
    finally:
        for name in mods:
            del sys.modules[name]
    g = run_cli.load_graph(str(path))
    raw = HGSampler(g, depth=2, width=4).sample_raw(
        {"paper": np.array([[0, 2010], [1, 2011]])})
    sampled = {t: len(v) for t, v in raw.node_ids.items()}
    ok = (isinstance(g, CSRGraph) and g.num_nodes == {"paper": 4, "venue": 1}
          and g.adj[("venue", "paper", "PV_in")].nnz == 2
          and sampled.get("venue", 0) == 1)
    log(f"[convert] a reference pickle through run.load_graph: {g}; one "
        f"sample of 2 papers: nodes {sampled} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[convert] the reference pickle did not convert")


# ------------------------------------------------------- the parallel modes
# [gp-kernels], [gp] / [dp] / [pp] / [tp], [gp-run], [pp-run], [dp-gp-run],
# [tp-kernels], [tp-run], [dp-tp-run]
GP = 2
PP_MICRO = 4
# a mode's step against the single-process step on the card, same inputs
# and weights, dropout 0, TF32 off: the loss within PAR_LOSS_TOL of its
# value, each gradient within PAR_GRAD_TOL of its tensor's max |ref|. dp
# and pp reorder f32 sums only; gp also sums each shard's partials in f32
# across ranks, so a bf16 rounding of a downstream per-edge tensor can flip
PAR_LOSS_TOL = 1e-3
PAR_GRAD_TOL = 2e-2
# the seeds of the bench batches each mode's step trains on
PAR_SEEDS = {"gp": (0,), "dp": (0, 1), "pp": tuple(range(PP_MICRO)),
             "tp": (0,)}
TP = 2
PAR_TIMED_STEPS = 3
# the parallel runs: (runner argv, cuts, ranks)
GP_RUN_CUTS = ["--n_epoch", "1", "--n_batch", "2", "--vr_num", "1"]
OAG_PAR_CUTS = ["--n_epoch", "1", "--n_batch", "2", "--repeat", "1"]
SLICE_FLAGS = ["--seg_pallas", "--edge_bf16", "--softmax_pallas"]


def gp_shard_aux(fl, batch):
    """The bench batch sorted as a gp run sorts it (no caps) and cut into
    GP shards with the preset's caps applied per shard."""
    from pyhgt_tpu_torch.parallel.edge_partition import partition_sorted

    se = sort_batch(batch, fl.layout, fl.em)
    lay, cfg = fl.layout, fl.cfg
    return partition_sorted(
        se, GP, num_blocks=len(lay.blocks), node_cap=lay.node_cap,
        num_nodes_flat=lay.num_types * lay.node_cap,
        tgt_rank_cap=cfg.seg_rank_cap, tab_cap=cfg.tab_cap)


def phase_gp_kernels(fl, dev, batch):
    """``live_partials`` (target aux) and ``live_partials_pair`` (src runs
    aux; the tab grouping's aux the gp step reads: the tab-window aux, or
    where a shard's tile spans more than two meta blocks, the tab runs aux)
    against their plain versions on each gp shard's aux of the bench batch,
    bf16 and f32; each timed in bf16 beside the shard's bound. Returns the
    shard keys of each kernel record and whether every shard has the
    window aux."""
    t0 = time.perf_counter()
    pe = gp_shard_aux(fl, batch)
    D = fl.cfg.n_hid
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {"live_partials": {}, "pair_runs": {}, "pair_window": {}}
    windows = all(sh.ptab_src is not None for sh in pe.shards)
    for i, sh in enumerate(pe.shards):
        E = sh.edge_tgt.shape[0]
        tiles = sh.pseg_tgt.loc.shape[0]
        tab = sh.ptab_src if windows else sh.pseg_tab
        tab_kind = "pair_window" if windows else "pair_runs"
        auxes = {"live_partials": ("", sh.pseg_tgt),
                 "pair src runs": ("src_", sh.pseg_src),
                 f"pair tab {'window' if windows else 'runs'}":
                     ("tab_", tab)}
        records = {"live_partials": "live_partials",
                   "pair src runs": "pair_runs",
                   f"pair tab {'window' if windows else 'runs'}": tab_kind}
        log(f"[gp-kernels] shard {i}: {E} edges ({tiles} tiles of K = "
            f"{sh.pseg_tgt.loc.shape[1]}), {int(sh.edge_mask.sum())} valid; "
            f"target aux W = {sh.pseg_tgt.w} V = {sh.pseg_tgt.v}, src runs "
            f"W = {sh.pseg_src.w}, tab window "
            + ("none (a tile spans more than two meta blocks: the step "
               "reduces the tab grouping on its runs aux)"
               if sh.ptab_src is None else f"W = V = {sh.ptab_src.w}")
            + f", tab compacted {sh.tab_sel is not None}")
        if (E, tiles) != (113_280, 295):
            raise AssertionError("[gp-kernels] the bench batch's shard is not "
                                 "295 tiles")
        d1 = torch.randn(E, D, generator=gen, device=dev)
        d2 = torch.randn(E, D, generator=gen, device=dev)
        for name, (prefix, aux) in auxes.items():
            gaux = aux.to(dev)
            err = 0.0
            for dtype in (torch.bfloat16, torch.float32):
                a, b = d1.to(dtype), d2.to(dtype)
                if prefix == "":
                    err = max(err, check_walk(
                        f"gp shard {i} live_partials W={aux.w} V={aux.v} "
                        f"{str(dtype)[6:]} {tuple(a.shape)}",
                        lambda: live_partials(a, gaux),
                        live_partials_plain(a, gaux),
                        live_partials_plain(a.abs(), gaux), gaux, D))
                else:
                    err = max(err, check_walk(
                        f"gp shard {i} live_partials_pair {name} W={aux.w} "
                        f"V={aux.v} {str(dtype)[6:]} {tuple(a.shape)}",
                        lambda: live_partials_pair(a, b, gaux),
                        live_partials_pair_plain(a, b, gaux),
                        live_partials_pair_plain(a.abs(), b.abs(), gaux),
                        gaux, D))
            a, b = d1.to(torch.bfloat16), d2.to(torch.bfloat16)
            rows = out_rows(gaux)
            zeros = torch.zeros(gaux.num_blocks * gaux.w, D, device=dev)
            if prefix == "":
                bound, nbytes = bound_ms(a, gaux)
                t = time_walk(
                    f"gp shard {i} live_partials bf16 {tuple(a.shape)}",
                    "live_partials", lambda x: live_partials(x, gaux), [a],
                    gaux, lambda x: live_partials_plain(x, gaux),
                    lambda: torch.index_add(zeros, 0, rows, a.float()),
                    "index_add (f32 source)", nbytes, bound)
            else:
                bound, nbytes = bound_ms(a, gaux, n_tensors=2)
                fa, fb = a.float(), b.float()
                t = time_walk(
                    f"gp shard {i} live_partials_pair {name} bf16 2 x "
                    f"{tuple(a.shape)}", "live_partials_pair",
                    lambda x, y: live_partials_pair(x, y, gaux), [a, b],
                    gaux, lambda x, y: live_partials_pair_plain(x, y, gaux),
                    lambda: (torch.index_add(zeros, 0, rows, fa),
                             torch.index_add(zeros, 0, rows, fb)),
                    "two index_add (f32 sources)", nbytes, bound)
            rec = out[records[name]]
            key = f"gp_shard_{prefix}max_abs_err"
            rec[key] = max(rec.get(key, 0.0), err)
            for k in ("ms", "graph_ms", "plain_ms", "library_ms",
                      "bound_ms"):
                rec.setdefault(f"gp_shard_{prefix}{k}", []).append(t[k])
    log(f"[gp-kernels] phase done in {time.perf_counter() - t0:.1f} s")
    return out, windows


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gib(dev):
    return (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else float("nan"))


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def phase_gp_window_kernel(dev, graph):
    """``live_partials_pair`` on a gp shard's tab-window aux, bf16 and f32,
    against its plain version: the bench batch's shards have none, so the
    shards of ``[ogbn]`` path items cut as ``run ogbn_mag --gp 2`` cuts
    them (its producer, the first of seeds 12-15 whose item gives a shard
    one). Returns the record keys."""
    cfg = served_config()
    sampler = make_sampler(cfg, graph, log=lambda msg: None)
    crng = np.random.default_rng(cfg.seed + 7)
    years = np.asarray(graph.aux["years"]).reshape(-1)

    def cal_seeds():
        pick = crng.choice(len(years), min(cfg.batch_size, len(years)),
                           replace=False)
        return {"paper": np.stack([pick, years[pick]], axis=1)}

    layout = make_layout(cfg, graph, sampler=sampler, seeds_fn=cal_seeds)
    em = EdgeStaticMeta.from_layout(layout)
    task = OgbnNodeTask(graph=graph, sampler=sampler, layout=layout,
                        batch_size=cfg.batch_size)
    producer = _make_producer(task.make_sample_fn("train"), layout, em, gp=GP)
    for seed in range(12, 16):
        shards = producer(np.random.default_rng(seed)).se.shards
        have = [i for i, sh in enumerate(shards) if sh.ptab_src is not None]
        log(f"[gp-window] item of seed {seed} cut in {GP}: tab-window aux on "
            f"shards {have} of {list(range(len(shards)))}")
        if have:
            break
    else:
        raise AssertionError("[gp-window] no gp shard with a tab-window aux")
    gen = torch.Generator(device=dev).manual_seed(8)
    err = 0.0
    for i in have:
        aux = shards[i].ptab_src
        gaux = aux.to(dev)
        E = aux.loc.size
        d1 = torch.randn(E, cfg.n_hid, generator=gen, device=dev)
        d2 = torch.randn(E, cfg.n_hid, generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            a, b = d1.to(dtype), d2.to(dtype)
            err = max(err, check_walk(
                f"gp shard {i} live_partials_pair tab window W={aux.w} "
                f"V={aux.v} {str(dtype)[6:]} {tuple(a.shape)}",
                lambda: live_partials_pair(a, b, gaux),
                live_partials_pair_plain(a, b, gaux),
                live_partials_pair_plain(a.abs(), b.abs(), gaux), gaux,
                cfg.n_hid))
    return {"gp_shard_window_max_abs_err": err}


def par_reference(dev, path, preset="bench"):
    """The single-process step on the card for every seed a mode trains on
    (bench preset, dropout 0): loss and gradients per seed, saved to
    ``path`` for the ranks; and the single-process step's time and peak
    memory on the seed-0 batch."""
    fl = build_flagship(preset, device=dev, seed=0, dropout=0.0)

    def loss_and_grads(seed):
        batch, labels = synth_flagship_batch(fl, seed=seed)
        fl.model.zero_grad(set_to_none=True)
        loss = fl.loss(batch, fl.sort(batch), labels)
        loss.backward()
        return (loss.item(), {n: p.grad.detach().cpu()
                              for n, p in fl.model.named_parameters()})

    per = {seed: loss_and_grads(seed)
           for seed in sorted({s for v in PAR_SEEDS.values() for s in v})}
    again = loss_and_grads(0)
    log(f"[determinism] single process ({preset} preset, dropout 0), the "
        f"seed-0 batch and the same weights twice: loss {per[0][0]:.6f} and "
        f"{again[0]:.6f} (equal {per[0][0] == again[0]}); gradients max err "
        f"{grads_err(again[1], per[0][1]):.2e} of each tensor's max |first| "
        f"| {card_line()}")
    torch.save(per, path)
    batch, labels = synth_flagship_batch(fl, seed=0)
    args = fl.to_device(batch, fl.sort(batch), labels)
    _, step = make_flagship_trainer(fl)
    float(step(*args))
    _sync(dev)
    _reset_peak(dev)
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED_STEPS):
        float(step(*args))
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / PAR_TIMED_STEPS
    peak = _peak_gib(dev)
    del fl, step, args
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ms, peak


def _par_mode(rank, mode, ref, dev, preset):
    """One mode on this rank: a step's loss, gradients and launches against
    the single-process reference, the parameters after the update equal on
    both ranks, then the step timed, and the peak memory."""
    import torch.distributed as dist

    from pyhgt_tpu_torch.bench import parallel_trainer
    from pyhgt_tpu_torch.parallel.spmd import make_step

    over = {"graph_axis": "graph"} if mode == "gp" else {}
    fl = build_flagship(preset, device=dev, seed=0, dropout=0.0, **over)
    vg, opt, args, n_edges = parallel_trainer(fl, mode, GP, PP_MICRO)
    names = {id(p): n for n, p in fl.model.named_parameters()}
    trained = [(names[id(p)], p) for p in opt.params]
    seeds = PAR_SEEDS[mode]
    want_loss = float(np.mean([ref[s][0] for s in seeds]))
    _sync(dev)
    _reset_peak(dev)
    reset_counts()
    opt.zero_grad()
    loss = float(vg(*args))
    _sync(dev)
    counts = read_counts()
    grad_err = 0.0
    for name, p in trained:
        want = sum(ref[s][1][name] for s in seeds) / len(seeds)
        err = float((p.grad.detach().float().cpu() - want).abs().max())
        grad_err = max(grad_err, err / max(float(want.abs().max()), 1e-12))
    opt.step()
    # the parameters after the update: equal on both ranks (under pp the
    # shared ones; each stage's layers are its own)
    shared = [p for n, p in trained
              if mode != "pp" or not n.startswith("gnn.convs.")]
    flat = torch.cat([p.detach().reshape(-1).float() for p in shared])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    same = bool(torch.equal(hi, lo))
    step = make_step(vg, opt)
    float(step(*args))
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED_STEPS):
        float(step(*args))
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / PAR_TIMED_STEPS
    peak = _peak_gib(dev)
    out = dict(loss=loss, want_loss=want_loss, grad_err=grad_err,
               counts=counts, same=same, n_shared=flat.numel(), ms=ms,
               peak=peak, n_edges=n_edges, n_trained=len(trained))
    if mode == "gp":
        out["allreduce_ms"] = _gp_allreduce_ms(fl, dev)
    del fl, vg, opt, args, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _gp_allreduce_ms(fl, dev):
    """The gloo all-reduces of one gp layer at the bench preset's sizes,
    timed alone (mean of 5, host clock after a synchronise): forward the
    softmax max and sum over [N, H] and the aggregation [N, D]; backward the
    Jacobian sum [N, H] and the core inputs' gradients in one flat buffer."""
    import torch.distributed as dist

    conv = fl.model.gnn.convs[0]
    N = fl.layout.num_types * fl.layout.node_cap
    D, H = fl.cfg.n_hid, fl.cfg.n_heads
    inputs = N * D + sum(getattr(conv, k).numel() for k in (
        "wq", "bq", "wk", "bk", "wv", "bv", "rel_pri", "rel_att",
        "rel_msg")) + conv.rte_table.shape[0] * D
    sizes = {"[N, H] x 3": (3, N * H), "[N, D] aggregation": (1, N * D),
             "core inputs' gradients": (1, inputs)}
    out = {}
    for what, (n, numel) in sizes.items():
        x = torch.randn(numel, device=dev)
        dist.all_reduce(x)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            for _ in range(n):
                dist.all_reduce(x)
            _sync(dev)
        out[what] = ((time.perf_counter() - t0) * 1e3 / 5, numel * 4 * n)
    return out


def grads_err(got, want):
    """The largest gradient error over the tensors of ``want``, each as a
    share of the tensor's max |want|."""
    return max(float((got[n].float() - w).abs().max())
               / max(float(w.abs().max()), 1e-12) for n, w in want.items())


def _tp_mode(rank, ref, dev, preset):
    """tp = 2 on this rank (a sharded copy of the flagship, the seed-0
    batch): the loss and every gradient, gathered over the model group,
    against the single-process reference; the same step's gradients twice
    (tp against itself); the launches of one step; the replicated
    parameters after the update equal on both ranks; the step timed, the
    peak memory, and the gloo collectives of one tp layer."""
    import torch.distributed as dist

    from pyhgt_tpu_torch.bench import parallel_trainer
    from pyhgt_tpu_torch.parallel import mesh as pmesh
    from pyhgt_tpu_torch.parallel.spmd import make_step

    fl = build_flagship(preset, device=dev, seed=0, dropout=0.0)
    vg, opt, args, n_edges = parallel_trainer(fl, "tp", TP)
    mesh = pmesh.make_mesh(n_data=1, n_model=TP)
    named = list(fl.model.named_parameters())
    axes = pmesh.param_shardings(named)

    def gathered():
        return {n: pmesh.join_along(p.grad.detach(), axes[n], mesh).cpu()
                for n, p in named}

    want_loss = ref[0][0]
    _sync(dev)
    _reset_peak(dev)
    reset_counts()
    opt.zero_grad()
    loss = float(vg(*args))
    _sync(dev)
    counts = read_counts()
    first = gathered()
    grad_err = grads_err(first, ref[0][1])
    opt.zero_grad()
    loss2 = float(vg(*args))
    self_err = grads_err(gathered(), first)
    opt.step()
    rep = [p for n, p in named if axes[n] is None]
    flat = torch.cat([p.detach().reshape(-1).float() for p in rep])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    same = bool(torch.equal(hi, lo))
    step = make_step(vg, opt)
    float(step(*args))
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED_STEPS):
        float(step(*args))
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / PAR_TIMED_STEPS
    peak = _peak_gib(dev)
    out = dict(loss=loss, loss2=loss2, want_loss=want_loss,
               grad_err=grad_err, self_err=self_err, counts=counts,
               same=same, n_shared=flat.numel(), ms=ms, peak=peak,
               n_edges=n_edges, n_trained=len(named),
               n_local=sum(p.numel() for _, p in named),
               allreduce_ms=_tp_collectives_ms(fl, dev, mesh))
    del fl, vg, opt, args, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _tp_collectives_ms(fl, dev, mesh):
    """The gloo collectives of one tp layer at the preset's sizes, timed
    alone (mean of 5, host clock after a synchronise): forward the
    row-parallel A linear's partial sums [N, D]; backward the gradients of
    the layer input and the RTE vectors entering the column-parallel
    projections ("f", one flat buffer); and once a step the adapters'
    column gather ([N, D / tp] from each rank)."""
    import torch.distributed as dist

    from pyhgt_tpu_torch.parallel import mesh as pmesh

    N = fl.layout.num_types * fl.layout.node_cap
    D = fl.cfg.n_hid
    L = fl.model.gnn.convs[0].rte_table.shape[0]
    group = mesh.group("model")
    sizes = {"[N, D] A-linear partial sums": N * D,
             "[N, D] + [L, D] input gradients (f)": N * D + L * D}
    out = {}
    for what, numel in sizes.items():
        x = torch.randn(numel, device=dev)
        dist.all_reduce(x, group=group)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            dist.all_reduce(x, group=group)
            _sync(dev)
        out[what] = ((time.perf_counter() - t0) * 1e3 / 5, numel * 4)
    cols = torch.randn(N, D // TP, device=dev)
    pmesh.all_gather(cols, group)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        pmesh.all_gather(cols, group)
        _sync(dev)
    out["[N, D / tp] adapter column gather (once a step)"] = (
        (time.perf_counter() - t0) * 1e3 / 5, cols.numel() * 4 * TP)
    return out


def par_world(rank, world, ref_path, device, preset):
    """The [gp], [dp], [pp] and [tp] checks on one rank of a 2-rank gloo
    world, every rank on ``device`` (the card's one device)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    ref = torch.load(ref_path, weights_only=True)
    out = {mode: _par_mode(rank, mode, ref, dev, preset)
           for mode in ("gp", "dp", "pp")}
    out["tp"] = _tp_mode(rank, ref, dev, preset)
    return out


def par_expected(mode, n_layers=4, gp_windows=True):
    """Launches per rank of one step: the single-device step's per layer
    times the layers and microbatches the rank runs (under gp each rank
    runs every layer on its shard, the pair's tab half on the runs aux
    where a shard has no window aux; the softmax kernel is skipped
    there)."""
    layers = n_layers // GP if mode == "pp" else n_layers
    micro = PP_MICRO if mode == "pp" else 1
    per = MAIN_STEP
    if mode == "gp" and not gp_windows:
        per = {"live_partials": 2, "pair_runs": 2}
    return scaled(per, layers * micro)


def phase_parallel(dev, workdir, preset="bench", gp_windows=True):
    """[gp], [dp], [pp], [tp]: the single-process reference on the card,
    then one 2-rank gloo world on cuda:0 (spawned once) running each mode's
    step at the bench preset's full width. Returns launches per mode
    (summed over the ranks) and the numbers for the log."""
    from pyhgt_tpu_torch.parallel.distributed import spawn

    t0 = time.perf_counter()
    ref_path = workdir / "par_ref.pt"
    single_ms, single_peak = par_reference(dev, ref_path, preset)
    log(f"[parallel] single-process step ({preset} preset, dropout 0, TF32 off) "
        f"{single_ms:.2f} ms, peak {single_peak:.2f} GiB | {card_line()}")
    t1 = time.perf_counter()
    ranks = spawn(par_world, GP, str(ref_path), str(dev), preset,
                  backend="gloo", threads=4)
    log(f"[parallel] one 2-rank gloo world on {dev} (backend gloo: both "
        f"ranks share the card), spawned once: {time.perf_counter() - t1:.1f}"
        f" s")
    launches = {}
    for mode in ("gp", "dp", "pp"):
        want = par_expected(mode, PRESETS_FL[preset].n_layers, gp_windows)
        ok = True
        for r, res in enumerate(ranks):
            m = res[mode]
            rel = abs(m["loss"] - m["want_loss"]) / abs(m["want_loss"])
            good = (rel <= PAR_LOSS_TOL and m["grad_err"] <= PAR_GRAD_TOL
                    and m["counts"] == want and m["same"])
            ok = ok and good
            log(f"[{mode}] rank {r}: loss {m['loss']:.6f} (single process "
                f"{m['want_loss']:.6f}, rel {rel:.2e}, tol {PAR_LOSS_TOL:g}); "
                f"{m['n_trained']} gradients, max err {m['grad_err']:.2e} of "
                f"the tensor's max |ref| (tol {PAR_GRAD_TOL:g}); launches "
                f"{m['counts']} (expected {want}); {m['n_shared']} parameter "
                f"values after the update equal on both ranks {m['same']}; "
                f"step {m['ms']:.2f} ms ({PAR_TIMED_STEPS} steps, {m['n_edges']}"
                f" valid edges a step), peak {m['peak']:.2f} GiB "
                f"{'ok' if good else 'FAIL'}")
        if mode == "gp":
            for what, (ms, nbytes) in ranks[0]["gp"]["allreduce_ms"].items():
                log(f"[gp] gloo all_reduce of {what} ({nbytes / 1e6:.1f} MB, "
                    f"CUDA tensors through the host) {ms:.2f} ms a layer")
        log(f"[{mode}] per-rank step against the single process's "
            f"{single_ms:.2f} ms: two processes time-sharing one card, not a "
            f"scaling result | {card_line()}")
        if not ok:
            raise AssertionError(f"[{mode}] a rank disagrees with the single "
                                 "process")
        launches[mode] = {k: sum(r[mode]["counts"][k] for r in ranks)
                          for k in NO_LAUNCH}
    launches["tp"] = tp_lines(ranks, single_ms, preset)
    ref_path.unlink()
    log(f"[parallel] phase done in {time.perf_counter() - t0:.1f} s")
    return launches


def tp_lines(ranks, single_ms, preset):
    """The [tp] checks and lines of the parallel world's ranks; returns
    the launches summed over the ranks."""
    want = par_expected("tp", PRESETS_FL[preset].n_layers)
    ok = True
    for r, res in enumerate(ranks):
        m = res["tp"]
        rel = abs(m["loss"] - m["want_loss"]) / abs(m["want_loss"])
        good = (rel <= PAR_LOSS_TOL and m["grad_err"] <= PAR_GRAD_TOL
                and m["counts"] == want and m["same"])
        ok = ok and good
        log(f"[tp] rank {r}: loss {m['loss']:.6f} (single process "
            f"{m['want_loss']:.6f}, rel {rel:.2e}, tol {PAR_LOSS_TOL:g}); "
            f"{m['n_trained']} gradients ({m['n_local']} values on this "
            f"rank) gathered over the model group, max err "
            f"{m['grad_err']:.2e} of the tensor's max |ref| (tol "
            f"{PAR_GRAD_TOL:g}); launches {m['counts']} (expected {want}); "
            f"{m['n_shared']} replicated parameter values after the update "
            f"equal on both ranks {m['same']}; step {m['ms']:.2f} ms "
            f"({PAR_TIMED_STEPS} steps, {m['n_edges']} valid edges a step), "
            f"peak {m['peak']:.2f} GiB {'ok' if good else 'FAIL'}")
        log(f"[determinism] tp = {TP} rank {r}, the seed-0 batch and the "
            f"same weights twice: loss {m['loss']:.6f} and {m['loss2']:.6f} "
            f"(equal {m['loss'] == m['loss2']}); gathered gradients max err "
            f"{m['self_err']:.2e} of each tensor's max |first|")
    for what, (ms, nbytes) in ranks[0]["tp"]["allreduce_ms"].items():
        log(f"[tp] gloo collective of {what} ({nbytes / 1e6:.1f} MB, CUDA "
            f"tensors through the host) {ms:.2f} ms")
    log(f"[tp] per-rank step against the single process's {single_ms:.2f} "
        f"ms: two processes time-sharing one card, not a scaling result | "
        f"{card_line()}")
    if not ok:
        raise AssertionError("[tp] a rank disagrees with the single process")
    return {k: sum(r["tp"]["counts"][k] for r in ranks) for k in NO_LAUNCH}


def add_mode_launches(rec, counter, mode_counts, total=True):
    """A kernel record's launches under each parallel mode (every rank,
    the mode's world and its runs), added to its total."""
    for mode, counts in mode_counts.items():
        rec[f"launches_{mode}"] = counts[counter]
        if total:
            rec["launches"] += counts[counter]


def torchrun(n, argv):
    """``python -m pyhgt_tpu_torch.run <argv>`` under torchrun with ``n``
    ranks; returns (exit code, stdout lines, per-rank launches, seconds)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), "-m", "pyhgt_tpu_torch.run", *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=str(ROOT))
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    key = "kernel launches per rank "
    per = next((json.loads(l[len(key):]) for l in lines
                if l.startswith(key)), None)
    if proc.returncode or per is None:
        log("\n".join(lines[-30:]))
        log(proc.stderr[-4000:])
    return proc.returncode, lines, per, secs


def run_expected(counts, L, steps, forwards, fwd=True, per_step=None):
    """Launches of one rank of a parallel run: ``steps`` layer-steps of the
    single-device step (``per_step``, default the OGBN step per layer; the
    pair's split between its aux kinds read from ``counts``) and
    ``forwards`` evaluation forwards of L layers on rank 0."""
    per_step = per_step or OGBN_STEP
    want = {k: per_step.get(k, 0) * steps + (OGBN_FORWARD.get(k, 0)
                                             * forwards * L if fwd else 0)
            for k in NO_LAUNCH}
    want["pair_window"] = counts["pair_window"]
    want["pair_runs"] = OGBN_PAIR * steps - counts["pair_window"]
    return want


def check_run(tag, rc, lines, per, secs, cfg_line, expect):
    """Assert a torchrun run: exit 0, finite losses, and each rank's
    launches (``expect(rank, counts)``)."""
    for line in lines:
        if line.startswith(("layout:", "epoch", "test", "dist:")):
            log(f"[{tag}]   {line}")
    epochs = [l for l in lines if l.startswith("epoch")]
    ok = rc == 0 and per is not None and epochs and all(
        "nan" not in l for l in epochs)
    if ok:
        for r, counts in enumerate(per):
            want = expect(r, counts)
            good = counts == want and counts["pair_runs"] > 0
            ok = ok and good
            log(f"[{tag}] rank {r}: launches {counts} (expected {want}) "
                f"{'ok' if good else 'FAIL'}")
    log(f"[{tag}] {cfg_line}: exit {rc} in {secs:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] the run failed")
    return {k: sum(c[k] for c in per) for k in NO_LAUNCH}


def gp_run_argv(workdir):
    return ["ogbn_mag", "--data", str(workdir / "graph"), "--model_dir",
            str(workdir / "gp_run"), "--gp", str(GP), "--dist_backend",
            "gloo", *SLICE_FLAGS, *GP_RUN_CUTS]


def oag_run_argv(tag, workdir, flags):
    return ["paper_field", "--data", str(workdir / "oag_graph"),
            "--model_dir", str(workdir / tag), *flags, "--dist_backend",
            "gloo", *SLICE_FLAGS, *OAG_PAR_CUTS]


def phase_gp_run(graph, workdir, started=None):
    """``run ogbn_mag --gp 2`` under torchrun on the ogbn-mag proxy with the
    slice's flags (1 epoch of 2 x repeat 2, the test split at vr_num 1),
    per-rank launches asserted; then ``run serve`` of rank 0's checkpoint
    answering 2 requests (``started``: the run's future, when
    :func:`start_runs` started it). Returns the launches of both."""
    cfg = served_config().replace(n_epoch=1, n_batch=2, vr_num=1, gp=GP)
    model_dir = workdir / "gp_run"
    argv = gp_run_argv(workdir)
    rc, lines, per, secs = (started.result() if started is not None
                            else torchrun(GP, argv))
    L = cfg.n_layers
    steps = cfg.n_batch * cfg.repeat * cfg.n_epoch
    n_test = int(np.asarray(graph.aux["test_mask"]).sum())
    forwards = 4 * cfg.n_epoch + -(-n_test // cfg.batch_size) * cfg.vr_num
    # under gp the softmax kernel is skipped in the steps; rank 0 alone
    # validates and evaluates on the single-device forward
    gp_step = {"live_partials": 2}
    counts = check_run(
        "gp-run", rc, lines, per, secs,
        f"torchrun --nproc_per_node {GP} -m pyhgt_tpu_torch.run "
        f"{' '.join(argv[:1] + argv[5:])} ({steps} steps, {forwards} forwards "
        f"on rank 0)",
        lambda r, c: run_expected(c, L, steps * L, forwards, r == 0,
                                  gp_step))
    best = model_dir / "ogbn_mag_hgt"
    reqs = [{"nodes": [0, 5, 9], "vr_num": 1}, {"nodes": [123], "vr_num": 2}]
    rc, out, served = run_main(
        ["serve", "--data", str(workdir / "graph"), "--ckpt", str(best),
         *SLICE_FLAGS], "".join(json.dumps(r) + "\n" for r in reqs))
    n_fwd = sum(r["vr_num"] for r in reqs)
    want = scaled(PREDICTOR_FORWARD, L * n_fwd)
    answers = [json.loads(l) for l in out]
    ok = (rc == 0 and served == want and len(answers) == 2 and all(
        a["nodes"] == q["nodes"] and len(a["pred"]) == len(q["nodes"])
        for a, q in zip(answers, reqs)))
    log(f"[gp-run-serve] run serve --ckpt {best.name} (rank 0's checkpoint "
        f"of the gp run): {len(answers)} answers, launches {served} "
        f"(expected {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[gp-run-serve] the gp checkpoint did not serve")
    return {k: counts[k] + served[k] for k in NO_LAUNCH}


def phase_oag_parallel_run(tag, workdir, n, flags, started=None):
    """``run paper_field`` under torchrun with ``n`` ranks and the parallel
    ``flags`` on the OAG proxy with the slice's flags (1 epoch of 2
    batches), per-rank launches asserted (``started``: the run's future,
    when :func:`start_runs` started it). Returns the launches summed over
    the ranks."""
    cfg = PRESETS["paper_field"].replace(n_epoch=1, n_batch=2, repeat=1)
    argv = oag_run_argv(tag, workdir, flags)
    rc, lines, per, secs = (started.result() if started is not None
                            else torchrun(n, argv))
    L = cfg.n_layers
    steps = cfg.n_batch * cfg.repeat * cfg.n_epoch
    forwards = cfg.n_epoch + OAG_TEST_BATCHES
    pp = "--pp" in flags
    if pp:
        # a stage runs its L / pp layers on each of the PP_MICRO microbatches
        layer_steps = steps * PP_MICRO * (L // GP)
        per_step = OGBN_STEP
    elif "--gp" in flags:
        layer_steps = steps * L
        per_step = {"live_partials": 2}     # gp: no softmax kernel
    else:
        # dp and tp: every rank runs the single-device step's kernels (tp
        # at D / tp columns and H / tp heads)
        layer_steps = steps * L
        per_step = OGBN_STEP
    return check_run(
        tag, rc, lines, per, secs,
        f"torchrun --nproc_per_node {n} -m pyhgt_tpu_torch.run "
        f"{' '.join(argv[:1] + argv[5:])} ({steps} steps"
        f"{f' of {PP_MICRO} microbatches' if pp else ''}, {forwards} "
        f"forwards on rank 0)",
        lambda r, c: run_expected(c, L, layer_steps, forwards, r == 0,
                                  per_step))


def phase_tp_kernels(fl, dev, batch, ogbn_graph, oag, workdir):
    """[tp-kernels]: the kernels at the width a tp = 2 rank gives them
    (D / tp columns, H / tp heads; the sorted batch and its aux are every
    model rank's): the bench batch at D 256 (its capped target aux: the
    walks), an ``[ogbn]`` path item at D 256 / 4 heads and a paper-field
    item at D 200 / 4 heads (the walks and the softmax partials), each held
    against its plain version and timed beside the bound at those bytes.
    Returns the record keys per kernel (``tp_bench_``, ``tp_ogbn_``,
    ``tp_oag_``)."""
    t0 = time.perf_counter()
    c = fl.cfg
    bench_cfg = PRESETS["ogbn_mag"].replace(n_hid=c.n_hid // TP,
                                            n_heads=c.n_heads // TP)
    out = {}

    def merge(part):
        for k, v in part.items():
            out.setdefault(k, {}).update(v)

    log(f"[tp-kernels] tp = {TP}: each model rank runs the edge stage on "
        f"D / tp columns and H / tp heads of the same sorted batch")
    merge(phase_path_kernels("tp_bench", dev, fl.sort(batch), bench_cfg,
                             softmax=False))
    item, _, cfg = ogbn_item(ogbn_graph)
    merge(phase_path_kernels("tp_ogbn", dev, item.se, cfg.replace(
        n_hid=cfg.n_hid // TP, n_heads=cfg.n_heads // TP)))
    ocfg = oag_config("paper_field", workdir)
    item = oag_field_item(ocfg, oag)[0]
    merge(phase_path_kernels("tp_oag", dev, item.se, ocfg.replace(
        n_hid=ocfg.n_hid // TP, n_heads=ocfg.n_heads // TP)))
    log(f"[tp-kernels] phase done in {time.perf_counter() - t0:.1f} s")
    return out


# the torchrun runs: (tag, ranks, flags); the gp run's argv is its own
OAG_RUNS = (("pp-run", GP, ["--pp", str(GP)]),
            ("dp-gp-run", 2 * GP, ["--dp", "2", "--gp", str(GP)]),
            ("tp-run", TP, ["--tp", str(TP)]),
            ("dp-tp-run", 2 * TP, ["--dp", "2", "--tp", str(TP)]))


# the training-step extras under torchrun, each started with the other
# runs and then resumed for one more epoch in a spawned world: (tag,
# runner, ranks, flags)
EXTRAS_RUNS = (
    ("tp-extras-run", "paper_field", TP,
     ["--tp", str(TP), "--fused_opt", "--param_bf16", "--remat"]),
    ("pp-extras-run", "ogbn_mag", GP, ["--pp", str(GP), "--fused_opt",
                                       "--remat"]),
    ("gp-extras-run", "ogbn_mag", GP, ["--gp", str(GP), "--remat"]),
)
# the remat step per layer on the runs' paths (the softmax kernel where
# the mode runs it: not under gp)
REMAT_RUN_STEP = {"live_partials": 3, "softmax": 2}


def extras_argv(tag, runner, workdir, flags):
    if runner == "ogbn_mag":
        return ["ogbn_mag", "--data", str(workdir / "graph"), "--model_dir",
                str(workdir / tag), *flags, "--dist_backend", "gloo",
                *SLICE_FLAGS, *GP_RUN_CUTS]
    return oag_run_argv(tag, workdir, flags)


def extras_config(tag, runner, flags, workdir):
    """The configuration of an extras run's second (resumed) epoch: the
    CLI run's, two epochs long."""
    knobs = {k: f"--{k}" in flags for k in ("fused_opt", "param_bf16",
                                           "remat")}
    mode = {m: int(flags[flags.index(f"--{m}") + 1])
            for m in ("tp", "pp", "gp") if f"--{m}" in flags}
    if runner == "ogbn_mag":
        base = served_config().replace(n_batch=2, vr_num=1)
    else:
        base = oag_config("paper_field", workdir).replace(n_batch=2, repeat=1)
    return base.replace(model_dir=str(workdir / tag), n_epoch=2, **mode,
                        **knobs)


def resume_world(rank, world, workdir, runner, cfg, device):
    """A rank of a resumed epoch: the runner (``paper_field`` or
    ``ogbn_mag``) under ``cfg`` with ``resume=True`` on ``device`` (the
    ogbn-mag test split cut to one batch); returns its log, losses and
    launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    lines = []
    reset_counts()
    if runner == "ogbn_mag":
        graph = CSRGraph.load_dir(str(Path(workdir) / "graph"), mmap=True)
        res = run_ogbn(cfg, graph, log=lines.append, resume=True, device=dev,
                       max_eval_nodes=cfg.batch_size)
    else:
        graph = CSRGraph.load_dir(str(Path(workdir) / "oag_graph"),
                                  mmap=True)
        res = run_node_classification(
            cfg, graph, label_meta=OAG_FIELD_LABEL, multi_label=True,
            feature_fn=feature_oag, log=lines.append, resume=True,
            device=dev)
    _sync(dev)
    return dict(lines=lines, counts=read_counts(),
                losses=[h["loss"] for h in res["history"]],
                fused=type(res["state"].optimizer.inner).__name__)


def extras_chain(tag, runner, n, flags, workdir, dev):
    """An extras run (torchrun, one epoch), then its resumed epoch in an
    ``n``-rank gloo world; returns both results."""
    from pyhgt_tpu_torch.parallel.distributed import spawn

    first = torchrun(n, extras_argv(tag, runner, workdir, flags))
    if first[0]:
        return first, None, 0.0
    t0 = time.perf_counter()
    ranks = spawn(resume_world, n, str(workdir), runner,
                  extras_config(tag, runner, flags, workdir), str(dev),
                  backend="gloo", threads=4)
    return first, ranks, time.perf_counter() - t0


def extras_expected(flags, cfg, steps, forwards):
    """``expect(rank, counts)`` of an extras run's epoch of ``steps``
    steps with ``forwards`` evaluation forwards on rank 0."""
    L = cfg.n_layers
    if "--pp" in flags:
        layer_steps = steps * PP_MICRO * (L // GP)
    else:
        layer_steps = steps * L
    per = ({"live_partials": 3} if "--gp" in flags else REMAT_RUN_STEP)
    return lambda r, c: run_expected(c, L, layer_steps, forwards, r == 0, per)


def phase_extras_run(tag, runner, n, flags, workdir, graph, started):
    """[tp-extras-run], [pp-extras-run], [gp-extras-run]: the CLI run of
    one epoch under the extras' flags, every rank's launches asserted (the
    recompute's included), then its second epoch resumed in a spawned
    world from rank 0's ``latest`` checkpoint, launches asserted again.
    Returns the launches of both, summed over the ranks."""
    (rc, lines, per, secs), ranks, resume_secs = started.result()
    cfg = extras_config(tag, runner, flags, workdir)
    argv = extras_argv(tag, runner, workdir, flags)
    steps = cfg.n_batch * cfg.repeat
    if runner == "ogbn_mag":
        n_test = int(np.asarray(graph.aux["test_mask"]).sum())
        forwards = 4 + -(-n_test // cfg.batch_size) * cfg.vr_num
        again_forwards = 4 + cfg.vr_num
    else:
        forwards = again_forwards = 1 + OAG_TEST_BATCHES
    first = check_run(
        tag, rc, lines, per, secs,
        f"torchrun --nproc_per_node {n} -m pyhgt_tpu_torch.run "
        f"{' '.join(argv[:1] + argv[5:])} ({steps} steps, {forwards} "
        f"forwards on rank 0)",
        extras_expected(flags, cfg, steps, forwards))
    expect = extras_expected(flags, cfg, steps, again_forwards)
    ok = ranks is not None and any(
        l.startswith("resumed from") for l in ranks[0]["lines"])
    again = dict(NO_LAUNCH)
    want_opt = "FlatAdamW" if "--fused_opt" in flags else "AdamW"
    for r, res in enumerate(ranks or ()):
        want = expect(r, res["counts"])
        good = (res["counts"] == want and len(res["losses"]) == 1
                and np.isfinite(res["losses"]).all()
                and res["fused"] == want_opt)
        ok = ok and good
        log(f"[{tag}-resume] rank {r}: epoch losses {res['losses']}, "
            f"optimizer {res['fused']}, launches {res['counts']} (expected "
            f"{want}) {'ok' if good else 'FAIL'}")
        again = {k: again[k] + res["counts"][k] for k in NO_LAUNCH}
    for line in (ranks[0]["lines"] if ranks else ()):
        if line.startswith(("resumed", "epoch")):
            log(f"[{tag}-resume]   {line}")
    log(f"[{tag}-resume] {runner} ({' '.join(flags)}) resumed for one more "
        f"epoch in a {n}-rank gloo world: {resume_secs:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}-resume] the run did not resume")
    return {k: first[k] + again[k] for k in NO_LAUNCH}


def start_runs(pool, workdir, dev):
    """Start the torchrun runs together on ``pool`` (each is host-bound, on
    its loader and its processes' start): ``[gp-run]``, the ``OAG_RUNS``
    and the ``EXTRAS_RUNS`` (each followed by its resumed epoch); returns
    their futures by tag. Their step times share the card and the host
    with each other."""
    tags = (["gp-run"] + [t for t, _, _ in OAG_RUNS]
            + [t for t, _, _, _ in EXTRAS_RUNS])
    log(f"[runs] {len(tags)} torchrun runs start together ("
        f"{', '.join(tags)}): their step times share the card and the host")
    runs = {"gp-run": pool.submit(torchrun, GP, gp_run_argv(workdir))}
    for tag, n, flags in OAG_RUNS:
        runs[tag] = pool.submit(torchrun, n, oag_run_argv(tag, workdir, flags))
    for tag, runner, n, flags in EXTRAS_RUNS:
        runs[tag] = pool.submit(extras_chain, tag, runner, n, flags, workdir,
                                dev)
    return runs


def phase_tp_run(dev, oag, workdir, started=None):
    """[tp-run]: ``run paper_field --tp 2`` under torchrun on the OAG proxy
    (1 epoch of 2 steps); then its second epoch resumed from rank 0's
    ``latest`` checkpoint by ``run_node_classification(resume=True)`` in a
    2-rank gloo world on the card (the CLI has no resume flag, as in the
    JAX package); then one process on the card loads that run's ``latest``
    checkpoint (the whole model and AdamW state, gathered over the model
    group) into the runner's model and answers one paper-field batch.
    Every launch asserted; returns the launches of all three."""
    from pyhgt_tpu_torch.parallel.distributed import spawn
    from pyhgt_tpu_torch.train.checkpoint import load_checkpoint
    from pyhgt_tpu_torch.train.step import make_eval_step

    first = phase_oag_parallel_run("tp-run", workdir, TP, ["--tp", str(TP)],
                                   started)
    cfg = oag_config("paper_field", workdir).replace(
        model_dir=str(workdir / "tp-run"), n_epoch=2, n_batch=2, repeat=1,
        tp=TP)
    t0 = time.perf_counter()
    ranks = spawn(resume_world, TP, str(workdir), "paper_field", cfg,
                  str(dev), backend="gloo", threads=4)
    secs = time.perf_counter() - t0
    L = cfg.n_layers
    again = {}
    ok = any(l.startswith("resumed from") for l in ranks[0]["lines"])
    for r, res in enumerate(ranks):
        want = run_expected(res["counts"], L, cfg.n_batch * L,
                            1 + OAG_TEST_BATCHES, r == 0, OGBN_STEP)
        good = (res["counts"] == want and len(res["losses"]) == 1
                and np.isfinite(res["losses"]).all())
        ok = ok and good
        log(f"[tp-run-resume] rank {r}: epoch losses {res['losses']}, "
            f"launches {res['counts']} (expected {want}) "
            f"{'ok' if good else 'FAIL'}")
        again = {k: again.get(k, 0) + res["counts"][k] for k in NO_LAUNCH}
    for line in ranks[0]["lines"]:
        if line.startswith(("resumed", "epoch")):
            log(f"[tp-run-resume]   {line}")
    log(f"[tp-run-resume] run_node_classification(tp = {TP}, resume=True) "
        f"in a {TP}-rank gloo world on {dev}: {secs:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[tp-run-resume] the tp run did not resume")
    item, layout, em, task, _ = oag_field_item(cfg, oag)
    model = node_classifier(cfg, layout, oag_in_dim(oag), task.n_classes,
                            "paper", head_mode="seeds").to(dev)
    path = workdir / "tp-run" / "paper_field_hgt_latest"
    reset_counts()
    state = load_checkpoint(str(path), TrainState(model, make_tx(
        cfg, model.named_parameters(), cfg.n_batch * cfg.repeat)))
    sub = item.tb.sub
    logp = make_eval_step(model)(
        torch.as_tensor(sub.node_feat, device=dev),
        torch.as_tensor(sub.node_mask, device=dev), item.se.to(dev),
        em.to(dev))
    _sync(dev)
    served = read_counts()
    n_moments = len(state.optimizer.inner.state)
    finite = bool(torch.isfinite(logp).all())
    want = scaled(PREDICTOR_FORWARD, L)
    ok = (int(state.step) == 2 * cfg.n_batch and n_moments == len(
        list(model.parameters())) and finite and served == want
        and tuple(logp.shape) == (cfg.batch_size, task.n_classes))
    log(f"[tp-run-load] one process on {dev} loads {path.name} of the tp "
        f"run (step {int(state.step)}, AdamW state of {n_moments} "
        f"parameters) into the paper-field model and answers one batch: "
        f"log-probs {tuple(logp.shape)} finite {finite}; launches {served} "
        f"(expected {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[tp-run-load] the tp checkpoint did not load "
                             "in one process")
    return {k: first[k] + again[k] + served[k] for k in NO_LAUNCH}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="print the top CUDA ops of a forward and of a "
                         "train step by device time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    phase_build()
    fl = build_flagship("bench", device=dev, seed=0)
    batch, labels = synth_flagship_batch(fl, seed=0)
    n_edges = int(batch.edge_mask.sum())
    single = phase_kernel(fl, dev, batch)
    pair = phase_pair_kernel(fl, dev, batch)
    others = [phase_softmax_kernel(fl, dev, batch),
              phase_head_sum_kernel(fl, dev),
              phase_weighted_kernel(fl, dev, batch),
              *phase_slab_kernel(fl, dev, batch)]
    hard = phase_hard_kernels(dev)
    gp_kernels, gp_windows = phase_gp_kernels(fl, dev, batch)
    logp0, serve_counts = phase_requests(fl, n_edges)
    phase_cpu(logp0)
    train_counts, _ = phase_train(dev, batch, labels, n_edges)
    main_grads = phase_grads(dev, batch, labels)
    # launches under the configuration that runs each kernel, each counted
    # from 0 just before that path ran
    config_counts, config_serve = dict(NO_LAUNCH), dict(NO_LAUNCH)
    for name, cfg in CONFIGS.items():
        counts, _ = phase_train(dev, batch, labels, n_edges,
                                tag=f"train-{name}",
                                overrides=cfg["overrides"],
                                weighted=cfg["weighted"],
                                step_counts=cfg["step"])
        served = phase_serve_config(dev, name)
        for k in cfg["step"]:
            if k not in MAIN_STEP:
                config_counts[k], config_serve[k] = counts[k], served[k]
    for name, cfg in CARD_ONLY.items():
        phase_train(dev, batch, labels, n_edges, tag=f"train-{name}",
                    overrides=cfg["overrides"], step_counts=cfg["step"])
    config_counts["head_sum"] = phase_head_sum_path(fl, dev, batch)["head_sum"]
    phase_config_grads(dev, batch, labels, main_grads)
    # the training-step extras at the bench preset, each against the
    # default step in this run; launches counted from 0 before each
    extras = [phase_fused_opt(dev, batch, labels),
              phase_param_bf16(dev, batch, labels),
              phase_remat(dev, batch, labels), phase_acc(dev)]
    # the predictor's graph, checkpoint and CLI run live in a temporary
    # directory, removed at the end
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = Path(tmp)
        pred, predictor_counts, _ = phase_predictor(dev, workdir)
        phase_predictor_parts(pred)
        phase_predictor_sort(pred)
        phase_predictor_cpu(pred, workdir)
        phase_predictor_burst(pred)
        phase_predictor_cli(workdir)
        ogbn_counts = phase_ogbn(dev, pred.task.graph, workdir,
                                 profile=args.profile)
        ogbn_kernels = phase_ogbn_kernels(dev, pred.task.graph)
        extras.append(ogbn_remat_steps(dev, pred.task.graph))
        gp_window = phase_gp_window_kernel(dev, pred.task.graph)
        if args.profile:
            phase_profile(fl, batch, labels, pred)
        oag = oag_graph(workdir)
        field_counts, oag_kernels = phase_oag_field(dev, oag, workdir,
                                                    profile=args.profile)
        venue_counts = phase_oag_venue(dev, workdir)
        link_counts, best = phase_oag_link(dev, oag, workdir)
        index_counts, link_serve_counts = phase_link_serve(dev, oag, best,
                                                           workdir)
        # the other convs and the segment edge path; DenseHGT's launches
        # (the sorted path's kernels) counted on the OAG and ogbn-mag paths
        convs_counts = phase_convs(dev, oag, workdir)
        phase_segment(dev, oag, workdir)
        dense_ogbn_counts = phase_dense_hgt_ogbn(dev, pred.task.graph,
                                                 workdir)
        dense_counts = {k: convs_counts[k] + dense_ogbn_counts[k]
                        for k in NO_LAUNCH}
        pre_counts = phase_preprocess_oag(dev, workdir)
        phase_convert(workdir)
        # the parallel modes: each run counted from 0 just before it ran,
        # on every rank
        par = phase_parallel(dev, workdir, gp_windows=gp_windows)
        tp_kernels = phase_tp_kernels(fl, dev, batch, pred.task.graph, oag,
                                      workdir)
        with ThreadPoolExecutor(1 + len(OAG_RUNS)
                                + len(EXTRAS_RUNS)) as pool:
            runs = start_runs(pool, workdir, dev)
            gp_run = phase_gp_run(pred.task.graph, workdir, runs["gp-run"])
            pp_run, dp_gp_run, tp_run, dp_tp_run = (
                phase_tp_run(dev, oag, workdir, runs[tag]) if tag == "tp-run"
                else phase_oag_parallel_run(tag, workdir, n, flags, runs[tag])
                for tag, n, flags in OAG_RUNS)
            extras_runs = [
                phase_extras_run(tag, runner, n, flags, workdir,
                                 pred.task.graph, runs[tag])
                for tag, runner, n, flags in EXTRAS_RUNS]
        mode_counts = {
            "gp": {k: par["gp"][k] + gp_run[k] for k in NO_LAUNCH},
            "dp": {k: par["dp"][k] + dp_gp_run[k] for k in NO_LAUNCH},
            "pp": {k: par["pp"][k] + pp_run[k] for k in NO_LAUNCH},
            "tp": {k: par["tp"][k] + tp_run[k] + dp_tp_run[k]
                   for k in NO_LAUNCH}}
        # the extras' launches: their phases' timed steps and runs
        extras = {k: sum(c[k] for c in extras + extras_runs)
                  for k in NO_LAUNCH}
        # the OAG path's launches: every run above, each counted from 0
        # just before it ran
        oag_counts = {k: sum(c[k] for c in (
            field_counts, venue_counts, link_counts, index_counts,
            link_serve_counts, pre_counts)) for k in NO_LAUNCH}

    # launches: the serving path's and the training path's, each counted
    # from 0 just before the path ran
    single["launches_serve"] = serve_counts["live_partials"]
    single["launches_train"] = train_counts["live_partials"]
    single["launches_predictor"] = predictor_counts["live_partials"]
    single["launches_ogbn"] = ogbn_counts["live_partials"]
    single["launches_oag"] = oag_counts["live_partials"]
    single["launches_dense_hgt"] = dense_counts["live_partials"]
    single["launches_extras"] = extras["live_partials"]
    single["launches"] = (single["launches_serve"] + single["launches_train"]
                          + single["launches_predictor"]
                          + single["launches_ogbn"] + single["launches_oag"]
                          + single["launches_dense_hgt"]
                          + single["launches_extras"])
    add_mode_launches(single, "live_partials", mode_counts)
    single.update(gp_kernels["live_partials"])
    single.update(tp_kernels["live_partials"])
    single.update(oag_kernels["live_partials"])
    single.update(ogbn_kernels["live_partials"])
    single.update({f"hard_{k}": v for k, v in hard["live_partials"].items()})
    for rec in pair:
        kind = rec.pop("kind")
        rec["launches_serve"] = serve_counts[f"pair_{kind}"]
        rec["launches_train"] = train_counts[f"pair_{kind}"]
        rec["launches_ogbn"] = ogbn_counts[f"pair_{kind}"]
        rec["launches_oag"] = oag_counts[f"pair_{kind}"]
        rec["launches_dense_hgt"] = dense_counts[f"pair_{kind}"]
        rec["launches_extras"] = extras[f"pair_{kind}"]
        rec["launches"] = (rec["launches_train"] + rec["launches_ogbn"]
                           + rec["launches_oag"] + rec["launches_dense_hgt"]
                           + rec["launches_extras"])
        add_mode_launches(rec, f"pair_{kind}", mode_counts)
        rec.update(gp_kernels[f"pair_{kind}"])
        rec.update(tp_kernels.get(f"pair_{kind}", {}))
        rec.update(oag_kernels.get(f"pair_{kind}", {}))
        rec.update(ogbn_kernels.get(f"pair_{kind}", {}))
        if kind == "window":
            rec.update(gp_window)
        rec.update({f"hard_{k}": v for k, v in hard["pair"].items()})
    for rec in others:
        counter = rec.pop("counter")
        add_mode_launches(rec, counter, mode_counts, total=False)
        if counter == "head_sum":
            rec["launches"] = rec["launches_standalone"] = config_counts[counter]
        else:
            rec["launches_serve"] = config_serve[counter]
            rec["launches_train"] = config_counts[counter]
            rec["launches"] = rec["launches_serve"] + rec["launches_train"]
            if counter == "softmax":
                rec["launches_predictor"] = predictor_counts[counter]
                rec["launches_ogbn"] = ogbn_counts[counter]
                rec["launches_oag"] = oag_counts[counter]
                rec["launches_dense_hgt"] = dense_counts[counter]
                rec["launches_extras"] = extras[counter]
                rec["launches"] += (rec["launches_predictor"]
                                    + rec["launches_ogbn"]
                                    + rec["launches_oag"]
                                    + rec["launches_dense_hgt"]
                                    + rec["launches_extras"])
                rec.update(oag_kernels["softmax"])
                rec.update(ogbn_kernels["softmax"])
                rec.update(tp_kernels["softmax"])
            elif counter.startswith("slab_"):
                rec.update(oag_kernels.get(counter, {}))
                rec.update(ogbn_kernels.get(counter, {}))
                rec.update(tp_kernels.get(counter, {}))
                rec.update({f"hard_{k}": v for k, v in hard["slab"].items()})
        rec["launches"] += sum(rec[f"launches_{m}"] for m in mode_counts)
        if not rec["launches"]:
            raise AssertionError(f"{rec['name']} was never launched on its "
                                 "path")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [single, *pair, *others]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
