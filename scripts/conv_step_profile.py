"""Where a train step's time goes for each conv at the paper_field preset's
full width, on one CUDA card.

    python3 scripts/conv_step_profile.py [--convs hgt,gcn,...]

Builds the OAG proxy at scale 0.1 (as ``chip_smoke.py``'s OAG phases do),
takes 8 producer items of the paper_field task (calibrated layout, the
loader's path) onto the card, and for each conv (HGT on the sorted path
with ``--seg_pallas --edge_bf16 --softmax_pallas``, HGT on the segment
path, and the six others) times 8 train steps over them by CUDA events
after 8 warm-up steps, then profiles 4 more with ``torch.profiler``: the
step, the card's busy time a step (the device time of its kernels, copies
and fills), and the top operators by the device time of the kernels they
launch. First it prints the batches' padding:
the share of masked edge slots and where they point. TF32 off, as in
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pyhgt_tpu_torch.config import PRESETS
from pyhgt_tpu_torch.datasets.features import feature_oag, oag_in_dim
from pyhgt_tpu_torch.datasets.oag_proxy import build
from pyhgt_tpu_torch.experiments.engine import (
    OAG_SPLITS, _label_step_args, _loader, _producer_for, make_layout,
    make_sampler, make_tx, node_classifier,
)
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.tasks.base import build_time_split_pairs
from pyhgt_tpu_torch.tasks.node_classification import NodeClassificationTask
from pyhgt_tpu_torch.train.step import make_train_step

# (name, conv_name, edge_impl)
CASES = [("hgt", "hgt", "sorted"), ("hgt-segment", "hgt", "segment"),
         ("dense_hgt", "dense_hgt", "sorted"), ("gcn", "gcn", "sorted"),
         ("gat", "gat", "sorted"), ("rgcn", "rgcn", "sorted"),
         ("han", "han", "sorted"), ("hetgnn", "hetgnn", "sorted")]
N_ITEMS, WARMUP, PROFILED = 8, 8, 4
TOP = 8


def self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--convs", default=",".join(c[0] for c in CASES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_step_profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}",
          flush=True)

    t0 = time.perf_counter()
    g = build(0.1, seed=0)
    cfg = PRESETS["paper_field"].replace(
        seg_pallas=True, edge_bf16=True, softmax_pallas=True,
        n_batch=N_ITEMS // 2)
    task = NodeClassificationTask(
        graph=g, sampler=make_sampler(cfg, g), layout=None,
        target_type="paper", label_meta=("field", "paper", "PF_in_L2"),
        batch_size=cfg.batch_size, feature_fn=feature_oag)
    pairs = build_time_split_pairs(g, task.rev_label_meta,
                                   OAG_SPLITS)["train"]
    crng = np.random.default_rng(cfg.seed + 7)
    layout = make_layout(cfg, g, sampler=task.sampler,
                         seeds_fn=lambda: task.build_seeds(pairs, crng)[0])
    task.layout = layout
    em = EdgeStaticMeta.from_layout(layout)
    producer = _producer_for(
        cfg, task.make_sample_fn(pairs, OAG_SPLITS["train"]), layout, em)
    with _loader(producer, cfg, dev, {}) as loader:
        items = loader.take(N_ITEMS)
    torch.cuda.synchronize()
    print(f"proxy, layout and {N_ITEMS} items in {time.perf_counter() - t0:.1f}"
          f" s: node cap {layout.node_cap} x {layout.num_types} types, "
          f"{layout.num_edges} padded edge slots", flush=True)
    for i, it in enumerate(items[::2]):
        sub = it.tb.sub
        mask = sub.edge_mask.cpu().numpy()
        off = ~mask
        tgt0 = int((sub.edge_tgt.cpu().numpy()[off] == 0).sum())
        print(f"item {i}: {int(mask.sum())} valid edges, {int(off.sum())} "
              f"masked ({off.mean():.3f} of the slots), {tgt0} of them with "
              f"target and source node 0", flush=True)

    in_dim = oag_in_dim(g)
    for name, conv, impl in CASES:
        if name not in args.convs.split(","):
            continue
        c = cfg.replace(conv_name=conv, edge_impl=impl)
        torch.cuda.reset_peak_memory_stats()
        model = node_classifier(c, layout, in_dim, task.n_classes, seed=3,
                                head_mode="seeds").to(dev)
        step = make_train_step(task.make_loss_fn(model, em.to(dev)),
                               make_tx(c, model.named_parameters(), N_ITEMS))
        step_args = _label_step_args(dev, model)
        gen = torch.Generator(device=dev)

        def run(n):
            for b in range(n):
                gen.manual_seed(b)
                loss = step(gen, *step_args(items[b % N_ITEMS]))
            return loss

        run(WARMUP)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = run(N_ITEMS)
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / N_ITEMS
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run(PROFILED)
            torch.cuda.synchronize()
        avg = prof.key_averages()
        busy = sum(self_device_us(e) for e in avg
                   if e.device_type == DeviceType.CUDA) / 1e3 / PROFILED
        ops = sorted((e for e in avg if e.device_type == DeviceType.CPU),
                     key=self_device_us, reverse=True)
        print(f"[{name}] step {step_ms:.2f} ms (CUDA events over {N_ITEMS} "
              f"steps after {WARMUP}); card busy {busy:.2f} ms a step (its "
              f"kernels, copies and fills under the profiler); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss "
              f"{float(loss):.4f}", flush=True)
        for e in ops[:TOP]:
            ms = self_device_us(e) / 1e3 / PROFILED
            print(f"[{name}]   {ms:8.3f} ms a step ({ms / busy:.3f})  "
                  f"{e.count // PROFILED:4d} calls  {e.key[:90]}", flush=True)
        del model, step


if __name__ == "__main__":
    main()
