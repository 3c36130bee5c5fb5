"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile]

Drives ``pyhgt_tpu_torch`` (never JAX) through its main paths at the
``bench`` preset (ogbn-mag reproduction widths: 4 HGT layers, n_hid 512,
8 heads, RTE, bf16 edge stage) and checks every hand-written kernel on them:

1. build the CUDA kernels from ``pyhgt_tpu_torch/csrc`` (nvcc, sm_90a), one
   compiler process per source, all started together;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (aux of a real sorted bench batch):
   ``live_partials`` on the capped and legacy target aux, and
   ``live_partials_pair`` on the src runs aux, the compacted and the
   uncompacted tab-window aux and the tab runs aux, each in bf16 and f32;
3. time each kernel, its plain version and the PyTorch calls that compute
   the same function (``index_add_``), beside the card's bound for the work;
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
   card with the CPU's plain path.

Any failed phase raises (exit code != 0). The line before the last carries
the card's name and power limit, the one before it the kernels' JSON; the
last line is ``{"ok": true, "device": {...}}``. ``--profile`` also prints
the top CUDA ops of one forward and of one train step by device time
(torch.profiler).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from pyhgt_tpu_torch.bench import make_flagship_trainer
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.ops import cuda_build
from pyhgt_tpu_torch.ops.pallas_seg import (
    PallasSegAux, out_rows, live_partials, live_partials_pair,
    live_partials_pair_plain, live_partials_plain,
)
from pyhgt_tpu_torch.sampling.sorted_batch import sort_batch

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


def reset_counts():
    live_partials.launches = 0
    live_partials_pair.launches = 0
    live_partials_pair.window_launches = 0


def read_counts():
    pair, window = (live_partials_pair.launches,
                    live_partials_pair.window_launches)
    return {"live_partials": live_partials.launches,
            "pair_runs": pair - window, "pair_window": window}


def phase_build():
    t0 = time.perf_counter()
    paths = cuda_build.build(["live_partials", "live_partials_pair"])
    log(f"[build] {len(paths)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
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
    record = None
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
                record = (x, gaux)

    x, gaux = record
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
    return {
        "name": "live_partials", "route": "cuda",
        "source": "pyhgt_tpu_torch/csrc/live_partials.cu",
        "replaces": "pyhgt_tpu/ops/pallas_seg.py:759",
        "launches": None, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": library_ms,
    }


def phase_pair_kernel(fl, dev, batch):
    """live_partials_pair against its plain version with the aux of a real
    sorted bench batch, bf16 and f32: the src runs aux (W = 384), the
    compacted tab-window aux (W = V = 64), the uncompacted one (no tab_cap:
    W = V = 240) and the tab runs aux. Timed in bf16 in the two cases the
    train step runs: src runs and compacted window."""
    se = fl.sort(batch)
    se_unc = sort_batch(batch, fl.layout, fl.em,
                        tgt_rank_cap=fl.cfg.seg_rank_cap)
    auxes = {
        "src-runs": se.pseg_src, "tab-window": se.ptab_src,
        "tab-window-uncompacted": se_unc.ptab_src, "tab-runs": se.pseg_tab,
    }
    shapes = {k: (a.w, a.v, a.window) for k, a in auxes.items()}
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
        records.append({
            "name": f"live_partials_pair ({kind} aux: {name})",
            "route": "cuda",
            "source": "pyhgt_tpu_torch/csrc/live_partials_pair.cu",
            "replaces": "pyhgt_tpu/ops/pallas_seg.py:275",
            "launches": None, "max_abs_err": errs[kind], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library_ms, "kind": kind,
        })
    return records


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
    expected = {"live_partials": cfg.n_layers * N_REQUESTS, "pair_runs": 0,
                "pair_window": 0}
    log(f"[serve] kernel launches {counts} (expected live_partials = "
        f"n_layers x requests, no pair launch: {expected})")
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


def phase_train(dev, batch, labels, n_edges):
    """The trainer's main path: a fresh seeded flagship, the bench's
    optimizer, one warm-up step and N_STEPS timed steps on one batch."""
    fl = build_flagship("bench", device=dev, seed=0)
    cfg = fl.cfg
    t0 = time.perf_counter()
    se = fl.sort(batch)
    sort_ms = (time.perf_counter() - t0) * 1e3
    args = fl.to_device(batch, se, labels)
    state, step = make_flagship_trainer(fl)
    before = {n: p.detach().clone() for n, p in fl.model.named_parameters()}
    warm = float(step(*args))                # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    reset_counts()
    losses, times = [], []
    for _ in range(N_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(*args)))    # reading the loss waits
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    log(f"[train] host sort with the backward's aux {sort_ms:.1f} ms (once); "
        f"warm-up loss {warm:.4f}")
    for i, (loss, ms) in enumerate(zip(losses, times)):
        log(f"[train] step {i}: loss {loss:.4f}, {ms:.2f} ms")
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
    log(f"[train] {N_STEPS} steps: {ms:.2f} ms/step (forward with dropout + "
        f"backward + clip + AdamW, batch resident on the card); {n_edges} "
        f"valid edges x {cfg.n_layers} layers / step time -> "
        f"{n_edges * cfg.n_layers / (ms / 1e3):.6g} train edges/s (counts "
        f"each edge once per layer; the [serve] edges/s counts each edge "
        f"once per forward)")
    per_step = 2 * cfg.n_layers
    expected = {"live_partials": per_step * N_STEPS,
                "pair_runs": cfg.n_layers * N_STEPS,
                "pair_window": cfg.n_layers * N_STEPS}
    log(f"[train] kernel launches {counts}: live_partials "
        f"{counts['live_partials'] / N_STEPS:g}/step, live_partials_pair "
        f"{(counts['pair_runs'] + counts['pair_window']) / N_STEPS:g}/step "
        f"(expected 2 x n_layers = {per_step} each)")
    if counts != expected:
        raise AssertionError(f"the train step's launches {counts} != "
                             f"{expected}")
    return counts, ms


def loss_and_grads(dev, batch, labels):
    fl = build_flagship("bench", device=dev, seed=0, dropout=0.0)
    loss = fl.loss(batch, fl.sort(batch), labels)
    loss.backward()
    return loss.item(), {n: p.grad.detach().float().cpu()
                         for n, p in fl.model.named_parameters()}


def phase_grads(dev, batch, labels):
    """One loss-and-gradient, dropout off, on the card (kernels) and on the
    CPU (plain path), from the same seeded weights."""
    loss_g, grads_g = loss_and_grads(dev, batch, labels)
    t0 = time.perf_counter()
    loss_c, grads_c = loss_and_grads("cpu", batch, labels)
    worst, worst_name = 0.0, ""
    for name, gc in grads_c.items():
        rel = ((grads_g[name] - gc).abs().max() / gc.abs().max()).item()
        if rel > worst:
            worst, worst_name = rel, name
    loss_err = abs(loss_g - loss_c)
    ok = worst <= GRAD_TOL and loss_err <= CPU_TOL
    log(f"[grads] loss GPU {loss_g:.5f} CPU {loss_c:.5f} (|diff| "
        f"{loss_err:.2e}, tol {CPU_TOL:g}); {len(grads_c)} parameter "
        f"gradients, worst max|GPU - CPU| / max|CPU| {worst:.3e} at "
        f"{worst_name} (tol {GRAD_TOL:g}); CPU pass "
        f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("GPU and CPU gradients disagree")


def phase_profile(fl, batch, labels):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
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
    logp0, serve_counts = phase_requests(fl, n_edges)
    phase_cpu(logp0)
    train_counts, _ = phase_train(dev, batch, labels, n_edges)
    phase_grads(dev, batch, labels)
    if args.profile:
        phase_profile(fl, batch, labels)

    # launches: the serving path's and the training path's, each counted
    # from 0 just before the path ran
    single["launches_serve"] = serve_counts["live_partials"]
    single["launches_train"] = train_counts["live_partials"]
    single["launches"] = single["launches_serve"] + single["launches_train"]
    for rec in pair:
        kind = rec.pop("kind")
        rec["launches_serve"] = serve_counts[f"pair_{kind}"]
        rec["launches_train"] = train_counts[f"pair_{kind}"]
        rec["launches"] = rec["launches_train"]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [single, *pair]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
