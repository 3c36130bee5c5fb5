"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile]

Drives ``pyhgt_tpu_torch`` (never JAX) through its main path at the
``bench`` preset (ogbn-mag reproduction widths: 4 HGT layers, n_hid 512,
8 heads, RTE, bf16 edge stage) and checks every hand-written kernel on it:

1. build the CUDA kernels from ``pyhgt_tpu_torch/csrc`` (nvcc, sm_90a);
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (aux of a real sorted bench batch);
3. time each kernel, its plain version and the one PyTorch call that
   computes the same function, beside the card's bound for the work;
4. answer 3 requests (synthetic batch -> host sort -> forward -> argmax
   over the 128 seeds, as ``OgbnPredictor.predict`` does per chunk),
   counting kernel launches;
5. compare one request's log-probs from the card with the same forward on
   the CPU (the plain path).

Any failed phase raises (exit code != 0). The line before the last carries
the card's name and power limit, the one before it the kernels' JSON; the
last line is ``{"ok": true, "device": {...}}``. ``--profile`` also prints
the forward's top CUDA ops by device time (torch.profiler).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.ops import cuda_build
from pyhgt_tpu_torch.ops.pallas_seg import (
    PallasSegAux, live_partials, live_partials_plain,
)
from pyhgt_tpu_torch.sampling.sorted_batch import sort_batch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
N_REQUESTS = 3
# kernel vs plain: both sum the same values in f32, in another order
KERNEL_TOL = 1e-4
# card (bf16 edge stage, kernel) vs CPU (plain path): per-edge tensors
# round to bf16 at 2^-8; sums run in another order on each side
CPU_TOL = 3e-2


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


def phase_build():
    t0 = time.perf_counter()
    paths = cuda_build.build(["live_partials"])
    log(f"[build] {len(paths)} kernel(s) in {time.perf_counter() - t0:.2f} s")
    for name, text in cuda_build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def live_partials_bytes(data, aux: PallasSegAux):
    """Bytes the function must move: data, loc and blk read once, the
    output written once."""
    n_tiles = aux.loc.shape[0]
    out_rows = aux.num_blocks * aux.w
    return (data.numel() * data.element_size() + aux.loc.numel() * 4
            + n_tiles * 4 + out_rows * data.shape[1] * 4)


def phase_kernel(fl, dev):
    """live_partials against its plain version at the main path's shapes,
    for the capped (bench) and legacy aux, bf16 and f32; timed at the main
    path's configuration (bf16, capped)."""
    batch, _ = synth_flagship_batch(fl, seed=0)
    auxes = {
        "capped": fl.sort(batch).pseg_tgt,
        "legacy": sort_batch(batch, fl.layout, fl.em).pseg_tgt,
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
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL)
            log(f"[kernel] live_partials {aux_name} W={aux.w} V={aux.v} "
                f"{str(dtype)[6:]} {tuple(x.shape)} -> {tuple(got.shape)}: "
                f"max_abs_err {err:.3e} (tol {KERNEL_TOL:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("live_partials disagrees with its plain "
                                     f"version ({aux_name}, {dtype})")
            max_err = max(max_err, err)
            if aux_name == "capped" and dtype == torch.bfloat16:
                record = (x, gaux)

    x, gaux = record
    n_tiles, K = gaux.loc.shape
    n_out = gaux.num_blocks * gaux.w
    rows = (gaux.blk[:n_tiles].long()[:, None] * gaux.w
            + gaux.loc.long()).reshape(-1)
    x32 = x.float()
    zeros = torch.zeros(n_out, x.shape[1], device=dev)
    ms = cuda_ms(lambda: live_partials(x, gaux))
    plain_ms = cuda_ms(lambda: live_partials_plain(x, gaux))
    library_ms = cuda_ms(lambda: torch.index_add(zeros, 0, rows, x32))
    nbytes = live_partials_bytes(x, gaux)
    bound_ms = max(nbytes / HBM_BYTES_PER_S,
                   x.numel() / F32_FLOPS) * 1e3
    log(f"[time] live_partials bf16 {tuple(x.shape)} W=V={gaux.w}: kernel "
        f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} "
        f"ms, index_add (f32 source) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s)")
    return {
        "name": "live_partials", "route": "cuda",
        "source": "pyhgt_tpu_torch/csrc/live_partials.cu",
        "replaces": "pyhgt_tpu/ops/pallas_seg.py:759",
        "launches": None, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": library_ms,
    }


def answer(fl, seed):
    """One request: synthetic batch -> host sort -> forward -> argmax."""
    t0 = time.perf_counter()
    batch, _ = synth_flagship_batch(fl, seed=seed)
    t1 = time.perf_counter()
    se = fl.sort(batch)
    t2 = time.perf_counter()
    logp = fl.forward(batch, se)
    pred = logp.argmax(dim=-1).cpu()
    t3 = time.perf_counter()
    return logp, pred, {"synth_ms": (t1 - t0) * 1e3,
                        "sort_ms": (t2 - t1) * 1e3,
                        "forward_ms": (t3 - t2) * 1e3}


def phase_requests(fl):
    cfg = fl.cfg
    n_edges = int(synth_flagship_batch(fl, seed=0)[0].edge_mask.sum())
    answer(fl, seed=100)                    # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    live_partials.launches = 0
    results = [answer(fl, seed=i) for i in range(N_REQUESTS)]
    launches = live_partials.launches
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
        f"{n_edges / ((srt + fwd) / 1e3):.6g} edges/s (sort + forward)")
    expected = cfg.n_layers * N_REQUESTS
    log(f"[serve] live_partials launches {launches} "
        f"(expected n_layers x requests = {expected})")
    if launches != expected:
        raise AssertionError("the main path did not run the kernel per layer")
    return results[0][0], launches


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


def phase_profile(fl):
    from torch.profiler import ProfilerActivity, profile

    batch, _ = synth_flagship_batch(fl, seed=0)
    se = fl.sort(batch)
    fl.forward(batch, se)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fl.forward(batch, se)
        torch.cuda.synchronize()
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="print the forward's top CUDA ops by device time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    phase_build()
    fl = build_flagship("bench", device=dev, seed=0)
    kernel = phase_kernel(fl, dev)
    logp0, launches = phase_requests(fl)
    kernel["launches"] = launches
    phase_cpu(logp0)
    if args.profile:
        phase_profile(fl)

    print(json.dumps({"kernels": [kernel]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
