"""One run of a training cell: set-up, the measured window, the traced
steps and the comparison with the plain reference.

- Set-up: the system under test (:mod:`benchmark.system`); its first
  ``check_steps`` steps on a loader of distinct batches (``repeat`` 1),
  through the window's own call ``step(gen, *step_args(item))`` with
  ``gen`` seeded as the runners seed it; then the window's loader (the
  traffic's ``repeat``) and one step from it, so that every shape is
  built and the loader's pipeline is running when the window opens.
- The window: a closed loop of that call on the loader's items, with no
  validation and no checkpoint, until ``seconds`` have passed on the host
  clock; it closes when the card has finished every queued step.
- ``--trace 1``: ``trace_steps`` more steps under ``torch.profiler``.
- Then the peak memory is read, the program's state freed, and the plain
  reference follows the first steps (:mod:`benchmark.check`).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark import check, spec, system, trace, weights
from benchmark.reference import batch as ref_batch
from benchmark.reference import train as ref_train
from pyhgt_tpu_torch.ops import pallas_seg

HOST_SPANS = ("bench.loader_next", "bench.step")
# the loader's seeds, apart from the weights' (benchmark.weights.STREAM)
CHECK_STREAM, WINDOW_STREAM = 1, 2


def _seed(seed: int, stream: int) -> int:
    return (int(seed) * 1_000_003 + stream) % (2**63)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)


def _close(loader) -> None:
    """Stop the loader and wait for its threads."""
    loader.stop()
    for t in loader._threads:
        t.join(timeout=60)
        if t.is_alive():
            raise RuntimeError("a loader thread did not stop")


def _first_grad_norms(opt, named) -> Dict[str, float]:
    """Each parameter's first gradient as AdamW got it, from its state
    after one update: ``exp_avg / (1 - beta1)``."""
    beta1 = opt.inner.param_groups[0]["betas"][0]
    state = opt.inner.state
    return {n: float(state[p]["exp_avg"].double().norm() / (1 - beta1))
            if "exp_avg" in state.get(p, {}) else 0.0
            for n, p in named.items()}


def _launch_counts() -> Dict[str, int]:
    return dict(pair=pallas_seg.live_partials_pair.launches,
                softmax=pallas_seg.segment_softmax_partials.launches)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, log: Callable[[str], None],
        mutate: Optional[Callable] = None) -> dict:
    """Run ``cell`` once; returns the result line's fields.
    ``mutate(system)`` (tests only) breaks the timed path underneath."""
    cfg, traffic = cell.config, cell.traffic
    sut = system.build(cfg, seed, device, log)
    if mutate is not None:
        mutate(sut)
    names_shapes = weights.names_shapes(sut.model)
    step, step_seed = stepper(sut, device)

    # set-up: the first steps, each on its own batch, recorded for the check
    n_check = traffic["check_steps"]
    firsts, prog = first_steps(sut, traffic, seed, step, n_check)

    loader = sut.loader(_seed(seed, WINDOW_STREAM), traffic["repeat"],
                        traffic)
    k = n_check
    with loader:
        it = iter(loader)
        item, _ = next(it)
        step(k, item)
        k += 1
        _sync(device)
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s; window of {seconds} s")

        marks, waits, counts, losses = [], [], [], []
        t0 = time.perf_counter()
        while True:
            tw = time.perf_counter()
            item, carry = next(it)
            waits.append(time.perf_counter() - tw)
            losses.append(step(k, item))
            marks.append(_mark(device))
            counts.append(carry.counts)
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t0

        traced_ctx = None
        if traced:
            traced_ctx = _traced_steps(sut, it, step, k,
                                       traffic["trace_steps"], device)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    _close(loader)
    loss_host = torch.stack(losses).float().cpu().numpy()
    failed = int((~np.isfinite(loss_host)).sum())
    window = dict(seconds=window_s, steps=len(marks), counts=counts,
                  step_ms=[_ms(a, b) for a, b in zip(marks, marks[1:])],
                  wait_ms=[w * 1e3 for w in waits])
    ms = np.asarray(window["step_ms"])
    log(f"window {window_s:.3f} s, {len(marks)} steps; step ms p50 "
        f"{np.median(ms):.2f} p95 {np.percentile(ms, 95):.2f} max "
        f"{ms.max():.2f}; loader wait ms mean {np.mean(waits) * 1e3:.2f} "
        f"max {np.max(waits) * 1e3:.2f}")

    # the program's state goes before the reference runs
    graph = system.plain_graph(sut.graph)
    node_cap, blocks = sut.layout.node_cap, sut.layout_blocks()
    del sut, loader, it, item, losses, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = compare(cfg, graph, firsts, prog, node_cap, blocks,
                     [step_seed(j) for j in range(n_check)], seed, device,
                     names_shapes)
    correct, checks = check.verdict(values, cfg["limits"])
    return dict(setup_s=setup_s, window=window, traced=traced_ctx,
                peak=peak, attempted=len(marks), failed=failed,
                correct=correct and failed == 0, checks=checks)


def stepper(sut, device):
    """``(step(k, item), step_seed(k))``: the window's call of step ``k``,
    its dropout generator reseeded as the runners reseed it
    (``engine._train_epoch``: epoch * 10000 + step in the epoch)."""
    spe = sut.ecfg.n_batch * sut.ecfg.repeat
    gen = torch.Generator(device=device)

    def step_seed(k: int) -> int:
        epoch, b = divmod(k, spe)
        return epoch * 10000 + b

    def step(k: int, item):
        gen.manual_seed(step_seed(k))
        return sut.step(gen, *sut.step_args(item))

    return step, step_seed


def first_steps(sut, traffic, seed, step, n):
    """The first ``n`` steps of ``sut`` on a loader of distinct batches,
    through the window's call ``step(k, item)``: each batch's carry (its
    raw sample and host arrays) and what the comparison reads of the
    program (losses, first gradients' and changes' norms, the first
    step's input to the first layer)."""
    params = dict(sut.model.named_parameters())
    p0 = {k: p.detach().cpu().clone() for k, p in params.items()}
    firsts, losses, grad_norms, taps = [], [], None, {}

    def tap(module, args):
        # the first layer's input of the first step: the node products of
        # the input adapter, before any edge stage rounds
        taps.setdefault("input", args[0].detach().float().cpu())

    hook = sut.model.gnn.convs[0].register_forward_pre_hook(tap)
    # one thread: the batches in the order of their draws, so that one
    # seed checks the same steps
    loader = sut.loader(_seed(seed, CHECK_STREAM), 1,
                        dict(traffic, n_pool=1), record=True)
    with loader:
        it = iter(loader)
        for k in range(n):
            item, carry = next(it)
            losses.append(step(k, item))
            firsts.append(carry)
            if k == 0:
                hook.remove()
                grad_norms = _first_grad_norms(sut.optimizer, params)
    _close(loader)
    return firsts, dict(
        losses=[float(x) for x in losses], grad_norms=grad_norms,
        inputs=taps["input"],
        change_norms={k: float((p.detach().cpu() - p0[k]).double().norm())
                      for k, p in params.items()})


def _traced_steps(sut, it, step, k, n, device) -> dict:
    """``n`` steps of the same loop with the card's activity under
    ``torch.profiler`` and the host's spans on its own clock."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    before = _launch_counts()
    counts, spans = [], []
    with profile(activities=acts) as prof:
        _sync(device)
        lo = time.time_ns()
        for j in range(n):
            a = time.time_ns()
            item, carry = next(it)
            b = time.time_ns()
            step(k + j, item)
            spans += [(HOST_SPANS[0], a, b), (HOST_SPANS[1], b, time.time_ns())]
            counts.append(carry.counts)
        _sync(device)
        hi = time.time_ns()
    after = _launch_counts()
    out = trace.summarize(prof, (lo, hi), spans)
    out.update(steps=n, counts=counts,
               launches={key: after[key] - before[key] for key in after})
    return out


def reference_batches(cfg, graph, firsts, node_cap, blocks):
    """The reference's batches of the recorded first steps, and how often
    the program's batches disagree with them."""
    pairs = None
    if cfg["loss"] == "kl":
        pairs = ref_batch.label_pairs(graph, tuple(cfg["label_meta"]),
                                      cfg["train_split"]["hi"])
    batches, bad = [], 0
    for carry in firsts:
        raw, tb = carry.raw, carry.host.tb
        ref, b1 = ref_batch.rebuild(graph, cfg, raw.node_ids, raw.node_time,
                                    node_cap, pairs)
        sub = tb.sub
        prog_arrays = dict(node_feat=sub.node_feat, node_mask=sub.node_mask,
                           edge_src=sub.edge_src, edge_tgt=sub.edge_tgt,
                           edge_dt=sub.edge_dt, edge_mask=sub.edge_mask,
                           labels=tb.labels, label_mask=tb.label_mask)
        b2, ref = ref_batch.judge(ref, prog_arrays, blocks)
        bad += b1 + b2
        batches.append(ref)
    return batches, bad


def compare(cfg, graph, firsts, prog, node_cap, blocks, step_seeds, seed,
            device, names_shapes) -> dict:
    """The compared numbers of the program's first steps against the
    plain reference's."""
    batches, bad = reference_batches(cfg, graph, firsts, node_cap, blocks)
    params0 = weights.draw(names_shapes, seed, device)
    ref = ref_train.run_steps(params0, batches, step_seeds, cfg,
                              graph["metas"], device)
    return check.numbers(prog, ref, bad)
