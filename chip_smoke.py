"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile]

Drives ``pyhgt_tpu_torch`` (never JAX) through its main paths at the
``bench`` preset (ogbn-mag reproduction widths: 4 HGT layers, n_hid 512,
8 heads, RTE, bf16 edge stage) and checks every hand-written kernel on them:

1. build the six CUDA kernels from ``pyhgt_tpu_torch/csrc`` (nvcc, sm_90a),
   one compiler process per source, all started together;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (aux of a real sorted bench batch), each in
   bf16 and f32: ``live_partials`` on the capped and legacy target aux;
   ``live_partials_pair`` on the src runs aux, the compacted and the
   uncompacted tab-window aux, the tab runs aux and a singleton-split aux
   with dead rows; ``live_partials_slab`` on the src runs aux and the
   tab-window aux; ``live_partials_weighted`` on the capped and legacy
   target aux and a singleton-split aux; ``head_sum_product``; ``segment_softmax_partials`` on the
   legacy target aux with the batch's masked rows at -1e30, on outputs
   whose memory held NaN (tail rows exactly 0, two calls bit-identical);
3. time each kernel, its plain version and the PyTorch calls that compute
   the same function, beside the card's bound for the work (the softmax
   kernel and its yardstick also as device time: 8 calls on 8 copies of the
   logits in one CUDA graph, cold L2);
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
   ``python -m pyhgt_tpu_torch.run serve`` as a subprocess.

Any failed phase raises (exit code != 0). The line before the last carries
the card's name and power limit, the one before it the kernels' JSON; the
last line is ``{"ok": true, "device": {...}}``. ``--profile`` also prints
the top CUDA ops of one forward, of one train step, of one step under
``edge_bwd="slab"``, of one forward under ``softmax_pallas``, of one
``segment_softmax_partials`` call and of one predictor request by device
time (torch.profiler).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pyhgt_tpu_torch.bench import make_flagship_trainer
from pyhgt_tpu_torch.config import PRESETS
from pyhgt_tpu_torch.datasets.mag_proxy import build as build_proxy
from pyhgt_tpu_torch.experiments.engine import (
    make_layout, make_tx, node_classifier,
)
from pyhgt_tpu_torch.experiments.serving import OgbnPredictor, serve_jsonl
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.native import build as native_build
from pyhgt_tpu_torch.ops import cuda_build, sorted_hgt
from pyhgt_tpu_torch.ops import pallas_seg as ps
from pyhgt_tpu_torch.ops.pallas_seg import (
    PallasSegAux, out_rows, live_partials, live_partials_pair,
    live_partials_pair_plain, live_partials_plain,
)
from pyhgt_tpu_torch.sampling.batch import pad_sample
from pyhgt_tpu_torch.sampling.sorted_batch import (
    pallas_seg_aux_split, sort_batch, sort_edges,
)
from pyhgt_tpu_torch.tasks.base import gather_features
from pyhgt_tpu_torch.train.checkpoint import save_checkpoint
from pyhgt_tpu_torch.train.step import TrainState

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


def phase_kernel(fl, dev, batch):
    """live_partials against its plain version at the main path's shapes,
    for the capped (bench) and legacy aux, bf16 and f32; timed at the main
    path's configuration (bf16, capped)."""
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
            got = live_partials(x, gaux)
            want = live_partials_plain(x, gaux)
            abs_sum = live_partials_plain(x.abs(), gaux)
            torch.cuda.synchronize()
            max_err = max(max_err, check_close(
                got, want, abs_sum, f"live_partials {aux_name} W={aux.w} "
                f"V={aux.v} {str(dtype)[6:]} {tuple(x.shape)}"))
            if aux_name == "capped" and dtype == torch.bfloat16:
                timed = (x, gaux)

    x, gaux = timed
    rows = out_rows(gaux)
    x32 = x.float()
    zeros = torch.zeros(gaux.num_blocks * gaux.w, x.shape[1], device=dev)
    ms = cuda_ms(lambda: live_partials(x, gaux))
    plain_ms = cuda_ms(lambda: live_partials_plain(x, gaux))
    library_ms = cuda_ms(lambda: torch.index_add(zeros, 0, rows, x32))
    bound, nbytes = bound_ms(x, gaux)
    log(f"[time] live_partials bf16 {tuple(x.shape)} W=V={gaux.w}: kernel "
        f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} "
        f"ms, index_add (f32 source) {library_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s)")
    return record("live_partials", "live_partials", 759, max_err, ms,
                  plain_ms, bound, library_ms)


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
    rows). Timed in bf16 in the two cases the train step runs: src runs and
    compacted window."""
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
            got = live_partials_pair(d1, d2, gaux)
            want = live_partials_pair_plain(d1, d2, gaux)
            abs_sum = live_partials_pair_plain(d1.abs(), d2.abs(), gaux)
            torch.cuda.synchronize()
            for i, (g, w, a) in enumerate(zip(got, want, abs_sum)):
                errs[kind] = max(errs[kind], check_close(
                    g, w, a, f"live_partials_pair[{i}] {name} W={aux.w} "
                    f"V={aux.v} {str(dtype)[6:]} {tuple(d1.shape)}"))
            if dtype == torch.bfloat16 and name in ("src-runs", "tab-window"):
                timed[kind] = (name, d1, d2, gaux)

    records = []
    for kind, (name, d1, d2, gaux) in timed.items():
        rows = out_rows(gaux)
        f1, f2 = d1.float(), d2.float()
        zeros = torch.zeros(gaux.num_blocks * gaux.w, d1.shape[1], device=dev)
        ms = cuda_ms(lambda: live_partials_pair(d1, d2, gaux))
        plain_ms = cuda_ms(lambda: live_partials_pair_plain(d1, d2, gaux))
        library_ms = cuda_ms(lambda: (torch.index_add(zeros, 0, rows, f1),
                                      torch.index_add(zeros, 0, rows, f2)))
        bound, nbytes = bound_ms(d1, gaux, n_tensors=2)
        log(f"[time] live_partials_pair {name} bf16 2 x {tuple(d1.shape)} "
            f"W={gaux.w} V={gaux.v} -> 2 x {tuple(zeros.shape)}: kernel "
            f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), plain "
            f"{plain_ms:.4f} ms, two index_add (f32 sources) "
            f"{library_ms:.4f} ms, bound {bound:.4f} ms "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s)")
        records.append(record(
            f"live_partials_pair ({kind} aux: {name})", "live_partials_pair",
            275, errs[kind], ms, plain_ms, bound, library_ms, kind=kind))
    return records


def time_line(what, ms, nbytes, plain_ms, library, library_ms, bound):
    log(f"[time] {what}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
        f"plain {plain_ms:.4f} ms, {library} {library_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s)")


def phase_slab_kernel(fl, dev, batch):
    """live_partials_slab against its plain version on the two aux the slab
    backward hands it (src runs, W = 384; compacted tab window, W = V = 64),
    bf16 and f32 [E, 2 x 512] slabs; timed in bf16 on both."""
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
            got = ps.live_partials_slab(x, gaux)
            want = ps.live_partials_slab_plain(x, gaux)
            abs_sum = ps.live_partials_slab_plain(x.abs(), gaux)
            torch.cuda.synchronize()
            for i, (g, w, a) in enumerate(zip(got, want, abs_sum)):
                err = max(err, check_close(
                    g, w, a, f"live_partials_slab[{i}] {name} W={aux.w} "
                    f"V={aux.v} {str(dtype)[6:]} {tuple(x.shape)}"))
        x = base.to(torch.bfloat16)
        rows = out_rows(gaux)
        f1, f2 = x[:, :D].float(), x[:, D:].float()
        zeros = torch.zeros(gaux.num_blocks * gaux.w, D, device=dev)
        ms = cuda_ms(lambda: ps.live_partials_slab(x, gaux))
        plain_ms = cuda_ms(lambda: ps.live_partials_slab_plain(x, gaux))
        library_ms = cuda_ms(lambda: (torch.index_add(zeros, 0, rows, f1),
                                      torch.index_add(zeros, 0, rows, f2)))
        bound, nbytes = bound_ms(x[:, :D], gaux, n_tensors=2)
        time_line(f"live_partials_slab {name} bf16 {tuple(x.shape)} "
                  f"W={gaux.w} V={gaux.v} -> 2 x {tuple(zeros.shape)}", ms,
                  nbytes, plain_ms, "two index_add (f32 halves)", library_ms,
                  bound)
        records.append(record(
            f"live_partials_slab ({kind} aux: {name})", "live_partials_slab",
            739, err, ms, plain_ms, bound, library_ms, counter=f"slab_{kind}",
            launches_config='edge_bwd="slab"'))
    return records


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
        if args.profile:
            phase_profile(fl, batch, labels, pred)

    # launches: the serving path's and the training path's, each counted
    # from 0 just before the path ran
    single["launches_serve"] = serve_counts["live_partials"]
    single["launches_train"] = train_counts["live_partials"]
    single["launches_predictor"] = predictor_counts["live_partials"]
    single["launches"] = (single["launches_serve"] + single["launches_train"]
                          + single["launches_predictor"])
    for rec in pair:
        kind = rec.pop("kind")
        rec["launches_serve"] = serve_counts[f"pair_{kind}"]
        rec["launches_train"] = train_counts[f"pair_{kind}"]
        rec["launches"] = rec["launches_train"]
    for rec in others:
        counter = rec.pop("counter")
        if counter == "head_sum":
            rec["launches"] = rec["launches_standalone"] = config_counts[counter]
        else:
            rec["launches_serve"] = config_serve[counter]
            rec["launches_train"] = config_counts[counter]
            rec["launches"] = rec["launches_serve"] + rec["launches_train"]
            if counter == "softmax":
                rec["launches_predictor"] = predictor_counts[counter]
                rec["launches"] += rec["launches_predictor"]
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
