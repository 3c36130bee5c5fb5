"""A/B timing of the segment-sum walks of two trees of this repo on one card.

    python3 scripts/seg_kernel_ab.py --tree parent=checkout/parent \\
        --tree change=. [--order parent,change,change,parent] [--out FILE]

Builds once, with this checkout's package, the host aux of the three batches
the walks run at: the ``bench`` preset's synthetic batch, one item of the
``[ogbn]`` path's calibrated layout (the ``ogbn_mag`` preset on the ogbn-mag
proxy at scale 0.1) and one paper-field item of the OAG path (the OAG proxy
at scale 0.1), as ``chip_smoke.py`` builds them. Then, for each tree in the
order given, a process of its own imports that tree's ``pyhgt_tpu_torch``
(its kernels built from its own sources) and times, on those aux with bf16
rows from a seed, ``live_partials`` on the target aux and
``live_partials_pair`` and ``live_partials_slab`` (where the width splits
into 128-aligned halves, as its contract asks) on the src runs and the
tab-window aux: the eager wrapper (CUDA events over 20 calls after 3, the
inputs warm in L2) and the device time of 8 calls on 8 copies of the
inputs in one CUDA graph replayed 20 times (cold L2). Prints one JSON line
per reading, each with the card's name and power limit, and writes them to
``--out``. Needs a CUDA card; the trees are compared in one process order
on one card, so run it as one command.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
AUX_FIELDS = ("loc", "blk", "ptr2", "live_key")
FLAGS = ("w", "v", "window", "dead_rows")
COPIES = 8


def build_auxes(path: Path):
    """The three batches' aux (this checkout's package), saved to ``path``
    as one npz: ``<batch>/<grouping>/<field>`` plus each batch's width."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pyhgt_tpu_torch.datasets.mag_proxy import build as build_proxy
    from pyhgt_tpu_torch.datasets.oag_proxy import build as build_oag_proxy
    from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch

    fl = build_flagship("bench", device="cpu", seed=0)
    batch, _ = synth_flagship_batch(fl, seed=0)
    batches = {"bench": (fl.cfg.n_hid, fl.sort(batch))}
    item, _, cfg = cs.ogbn_item(build_proxy(cs.PROXY_SCALE, seed=0))
    batches["ogbn"] = (cfg.n_hid, item.se)
    cfg = cs.PRESETS["paper_field"].replace(**cs.OAG_FLAGS, dropout=0.0)
    item = cs.oag_field_item(cfg, build_oag_proxy(cs.OAG_SCALE, seed=0))[0]
    batches["oag"] = (cfg.n_hid, item.se)
    arrays = {}
    for name, (D, se) in batches.items():
        arrays[f"{name}/D"] = np.array(D)
        for group, aux in (("tgt", se.pseg_tgt), ("src", se.pseg_src),
                           ("tab", se.ptab_src)):
            if aux is None:
                continue
            for f in AUX_FIELDS:
                if getattr(aux, f) is not None:
                    arrays[f"{name}/{group}/{f}"] = np.asarray(getattr(aux, f))
            for f in FLAGS:
                arrays[f"{name}/{group}/{f}"] = np.array(getattr(aux, f))
    np.savez(path, **arrays)


def cuda_ms(torch, fn, iters=20, warmup=3):
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


def graph_ms(torch, fns, replays=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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


def time_tree(tree: str, label: str, aux_path: str, card: str):
    """Time ``tree``'s wrappers on the saved aux; one JSON line each."""
    sys.path.insert(0, tree)
    from pyhgt_tpu_torch.ops import pallas_seg as ps

    if not Path(ps.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise SystemExit(f"imported {ps.__file__}, not the tree {tree}")
    for line in time_walks(ps, label, aux_path, card):
        print(json.dumps(line), flush=True)


def time_walks(ps, label: str, aux_path: str, card: str):
    """The readings of the module docstring through the wrappers of the
    ``pallas_seg`` module ``ps``, as dicts."""
    import torch

    dev = torch.device("cuda")
    z = np.load(aux_path)
    lines = []
    for name in ("bench", "ogbn", "oag"):
        D = int(z[f"{name}/D"])
        auxes = {}
        for group in ("tgt", "src", "tab"):
            if f"{name}/{group}/loc" not in z:
                continue
            kw = {f: z[f"{name}/{group}/{f}"] for f in AUX_FIELDS
                  if f"{name}/{group}/{f}" in z}
            kw.update({f: z[f"{name}/{group}/{f}"].item() for f in FLAGS})
            auxes[group] = ps.PallasSegAux(**kw).to(dev)
        E = auxes["tgt"].loc.numel()
        gen = torch.Generator(device=dev).manual_seed(3)
        slab = torch.randn(E, 2 * D, generator=gen, device=dev).bfloat16()
        d1, d2 = slab[:, :D].contiguous(), slab[:, D:].contiguous()
        cases = [
            ("live_partials", "tgt", lambda a, g: ps.live_partials(a[0], g),
             [d1]),
            ("live_partials_pair", "src",
             lambda a, g: ps.live_partials_pair(a[0], a[1], g), [d1, d2]),
            ("live_partials_pair", "tab",
             lambda a, g: ps.live_partials_pair(a[0], a[1], g), [d1, d2]),
            ("live_partials_slab", "src",
             lambda a, g: ps.live_partials_slab(a[0], g), [slab]),
            ("live_partials_slab", "tab",
             lambda a, g: ps.live_partials_slab(a[0], g), [slab]),
        ]
        for kernel, group, call, inputs in cases:
            # the slab's contract takes 128-aligned halves (not D = 400)
            if group not in auxes or (kernel == "live_partials_slab"
                                      and D % 128):
                continue
            g = auxes[group]
            eager = cuda_ms(torch, lambda: call(inputs, g))
            copies = [[t.clone() for t in inputs] for _ in range(COPIES)]
            cold = graph_ms(torch, [lambda c=c: call(c, g) for c in copies])
            del copies
            lines.append({
                "tree": label, "batch": name, "kernel": kernel, "aux": group,
                "tiles": int(g.loc.shape[0]), "D": D, "w": g.w, "v": g.v,
                "window": g.window, "eager_ms": eager, "graph_ms": cold,
                "card": card})
    return lines


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=DIR, a tree of this repo (two of them)")
    ap.add_argument("--order", default=None,
                    help="labels in run order (default A,B,B,A)")
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--time", nargs=3, metavar=("TREE", "LABEL", "AUX"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--card", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        time_tree(*args.time, args.card)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("seg_kernel_ab: no CUDA device")
    trees = dict(t.split("=", 1) for t in args.tree)
    if len(trees) != 2:
        raise SystemExit("give two --tree LABEL=DIR")
    a, b = trees
    order = args.order.split(",") if args.order else [a, b, b, a]
    card = card_line()
    lines = []
    with tempfile.TemporaryDirectory(prefix="seg_ab_") as tmp:
        aux = Path(tmp) / "aux.npz"
        build_auxes(aux)
        for label in order:
            tree = os.path.abspath(trees[label])
            out = subprocess.run(
                [sys.executable, __file__, "--time", tree, label, str(aux),
                 "--card", card], capture_output=True, text=True)
            if out.returncode:
                raise SystemExit(f"{label} ({tree}) failed:\n{out.stderr}")
            for line in out.stdout.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
                    lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
