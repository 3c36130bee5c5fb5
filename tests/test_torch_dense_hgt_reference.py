"""The port's DenseHGT classifier against the benchmark's plain reference
(``benchmark/reference/dense_hgt.py``, plain PyTorch), at a small size on
seeded random weights: log-probs, loss, every parameter's gradient and
one AdamW step, on the sorted edge path (the kernels' plain versions on
the CPU; f32 and bf16 edge stage) and on the segment path. Planted faults
in the reference (the FFN left out, the final norm as a torch LayerNorm,
a layer's two dropout masks swapped) must fail the same comparison. The
FFN's call counter advances by one per layer and forward; on the card,
a replayed step advances it as an eager one does.

The system is built as the benchmark builds it (``benchmark.system``:
the proxy graph, the C++ sampler, the calibrated layout, the benchmark's
weights, the runners' step and loader), from the ``dense-hgt-ogbn-mag``
configuration cut to a toy size."""

from __future__ import annotations

import json
import statistics

import pytest
import torch
import torch.nn.functional as F

from benchmark import session, system
from benchmark.reference import dense_hgt as ref
from benchmark.reference import train as ref_train
from benchmark.spec import ROOT, TRAFFIC_KEYS
from pyhgt_tpu_torch.models.conv import ffn_counts
from pyhgt_tpu_torch.train.step import nll_loss
from pyhgt_tpu_torch.utils import counters

SEED = 2_100_000_003
TINY = dict(n_hid=64, n_heads=4, n_layers=2, sample_depth=2, sample_width=16,
            graph_scale=0.002, batch_size=16)
TRAFFIC = dict(n_pool=1, repeat=1, queue_size=2, check_steps=1,
               trace_steps=1)
# The typed norms' output (the FFN's input and half of the final norm's)
# scaled down from the benchmark's unit scale: the final norm then sees a
# variance of about 1e-3, where its epsilon (1e-6, flax's, against torch's
# 1e-5) moves its output by 0.5%, not by the 5e-6 it moves at unit scale,
# under the f32 round-off
NORM_CUT = 0.03
# name -> (edge path, bf16 edge stage)
VARIANTS = {"sorted_f32": ("sorted", False), "sorted_bf16": ("sorted", True),
            "segment": ("segment", False)}
# Tolerances, each a gap over the reference's scale (``_gaps``), with the
# readings of four dropout seeds on this batch (one thread, deterministic
# algorithms). f32 edge stage: both sides compute the same float32
# numbers and differ by summation order alone (the plain kernels' segment
# sums against the reference's index_add, the typed products batched
# against per-type ones): log-probs up to 2.1e-7, loss 1.4e-7, gradients
# 5.9e-7, all held at 1e-5; the planted faults read 2e-3 to 33. bf16
# edge stage: keys, values and messages round to bfloat16 (8 bits), and a
# reordered sum flips single roundings, which the layers carry on:
# log-probs up to 7.4e-5 and the loss 2.4e-6, held at 3e-3; element by
# element the query and key banks' gradients sit 3.3-3.6e-3 of their norm
# apart (their norms agree to 1e-4), held at 1.5e-2. The AdamW step, by
# each parameter's change (``update_norm_gap``'s measure): 1.1e-6 (f32)
# and 7.9e-4 (bf16), held at 1e-4 and 1e-2.
TOL = {False: dict(logp=1e-5, loss=1e-5, grad=1e-5, step=1e-4),
       True: dict(logp=3e-3, loss=3e-3, grad=1.5e-2, step=1e-2)}


def _cfg(edge_impl: str, edge_bf16: bool) -> dict:
    cfg = json.loads((ROOT / "benchmark/configs/dense-hgt-ogbn-mag.json")
                     .read_text())
    cfg.update(TINY, edge_impl=edge_impl, edge_bf16=edge_bf16)
    return cfg


@pytest.fixture(autouse=True)
def _deterministic():
    """torch's deterministic algorithms on one thread: on the CPU an
    ``index_add_`` or the backward of an indexed read adds its rows from
    several threads as they are scheduled, so under a loaded host a
    gradient moves by a few ulp from one call to the next, and the layers
    carry that on."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    threads = torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(was, warn_only=warn)


@pytest.fixture(scope="module")
def graph():
    return system.make_graph(_cfg("sorted", False))


def _quiet(msg):
    pass


def _build(cfg, graph, device=torch.device("cpu")):
    """The system with the benchmark's weights of :data:`SEED`, the typed
    norms' scales and biases cut by :data:`NORM_CUT`."""
    sut = system.build(cfg, SEED, device, _quiet, graph=graph)
    with torch.no_grad():
        for name, p in sut.model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("ln_scale", "ln_bias"):
                p.mul_(NORM_CUT)
    return sut


def _first_item(sut, seed: int):
    """The system's first loader item and its recorded carry."""
    assert set(TRAFFIC) == TRAFFIC_KEYS
    loader = sut.loader(seed, 1, TRAFFIC, record=True)
    with loader:
        item, carry = next(iter(loader))
    session._close(loader)
    return item, carry


@pytest.fixture(scope="module")
def runs(graph):
    """Per variant: the system, its first batch, the reference's batch."""
    out = {}
    for name, (edge_impl, bf16) in VARIANTS.items():
        cfg = _cfg(edge_impl, bf16)
        sut = _build(cfg, graph)
        item, carry = _first_item(sut, SEED + 1)
        plain = system.plain_graph(sut.graph)
        (rb,), bad = session.reference_batches(
            cfg, plain, [carry], sut.layout.node_cap, sut.layout_blocks())
        assert bad == 0
        out[name] = dict(cfg=cfg, sut=sut, item=item, rb=rb,
                         metas=plain["metas"])
    return out


def _program(sut, item, gen_seed: int):
    """Log-probs, loss and gradients of the program's forward in train
    mode (dropout from a generator seeded ``gen_seed``)."""
    nf, nmk, se, labels, lmask, edges = sut.step_args(item)
    model = sut.model
    model.train()
    model.zero_grad()
    gen = torch.Generator().manual_seed(gen_seed)
    logp = model(nf, nmk, se, sut.em.to(sut.device), gen, edges)
    loss = nll_loss(logp, labels, mask=lmask)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad()
    return logp.detach(), float(loss), grads


def _reference(sut, run, gen_seed: int):
    cfg, rb = run["cfg"], run["rb"]
    params = {n: p.detach().clone().requires_grad_(True)
              for n, p in sut.model.named_parameters()}
    gen = torch.Generator().manual_seed(gen_seed)
    masks = ref.dropout_masks(gen, len(rb.types), rb.node_cap, cfg["n_hid"],
                              cfg["n_layers"], cfg["dropout"], "cpu")
    prec = ref.Precision(cfg["edge_bf16"])
    logp = ref.forward(params, rb, cfg, run["metas"], prec, masks, "cpu")
    loss = ref.loss(logp, rb, cfg, "cpu")
    names = sorted(params)
    got = torch.autograd.grad(loss, [params[n] for n in names],
                              allow_unused=True)
    grads = {n: torch.zeros_like(params[n]) if g is None else g
             for n, g in zip(names, got)}
    return logp.detach(), float(loss), grads


def _gaps(run, gen_seed: int = 7) -> dict:
    """The program's forward and gradients against the reference's: the
    log-probs' widest gap over their widest value, the loss's relative
    gap, and by the worst parameter the gradient's gap (a norm) over the
    larger of its reference norm and the median parameter's."""
    sut = run["sut"]
    p_logp, p_loss, p_grads = _program(sut, run["item"], gen_seed)
    r_logp, r_loss, r_grads = _reference(sut, run, gen_seed)
    rows = r_logp.shape[0]
    norms = {n: float(g.norm()) for n, g in r_grads.items()}
    med = statistics.median(norms.values())
    return dict(
        logp=float((p_logp[:rows] - r_logp).abs().max()
                   / r_logp.abs().max()),
        loss=abs(p_loss - r_loss) / abs(r_loss),
        grad=max(float((p_grads[n] - r_grads[n]).norm())
                 / max(norms[n], med) for n in r_grads))


def _over(gaps: dict, tol: dict) -> list:
    return [k for k, v in gaps.items() if not v <= tol[k]]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_gradients_match_reference(runs, variant):
    run = runs[variant]
    gaps = _gaps(run)
    assert not _over(gaps, TOL[run["cfg"]["edge_bf16"]]), gaps


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_adamw_step_matches_reference(runs, variant, graph):
    """One step of the runners' step (clip, AdamW under OneCycle, the decay
    mask) against the reference's, by each parameter's change; on a fresh
    system, as the step changes the weights."""
    run = runs[variant]
    cfg = run["cfg"]
    sut = _build(cfg, graph)
    before = {n: p.detach().clone() for n, p in sut.model.named_parameters()}
    gen = torch.Generator().manual_seed(11)
    sut.step(gen, *sut.step_args(run["item"]))
    prog = {n: float((p.detach() - before[n]).double().norm())
            for n, p in sut.model.named_parameters()}
    want = ref_train.run_steps(before, [run["rb"]], [11], cfg, run["metas"],
                               "cpu")["change_norms"]
    med = statistics.median(want.values())
    gap = max(abs(prog[n] - want[n]) / max(want[n], med) for n in want)
    assert gap <= TOL[cfg["edge_bf16"]]["step"], gap


def _swap_layer_masks(dropout_masks):
    def masks(*args, **kw):
        m = dropout_masks(*args, **kw)
        for li in range((len(m) - 1) // 2):
            m[1 + 2 * li], m[2 + 2 * li] = m[2 + 2 * li], m[1 + 2 * li]
        return m
    return masks


FAULTS = {
    "ffn_left_out": ("_ffn", lambda orig: (
        lambda res, P, prec: torch.zeros_like(res))),
    "final_norm_torch": ("_final_norm", lambda orig: (
        lambda x, scale, bias: F.layer_norm(x, x.shape[-1:], scale, bias,
                                            eps=1e-5))),
    "dropout_masks_swapped": ("dropout_masks", _swap_layer_masks),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails(runs, fault, monkeypatch):
    """Each fault, planted in the reference, fails the f32 comparison."""
    attr, make = FAULTS[fault]
    monkeypatch.setattr(ref, attr, make(getattr(ref, attr)))
    gaps = _gaps(runs["sorted_f32"])
    assert _over(gaps, TOL[False]), gaps


def test_ffn_counters_advance_per_forward(runs):
    run = runs["sorted_f32"]
    calls = ffn_counts.calls
    _program(run["sut"], run["item"], 3)
    assert ffn_counts.calls - calls == run["cfg"]["n_layers"]
    # among the counters a graph's replay advances
    assert (ffn_counts, "calls") in counters.snapshot()


@pytest.mark.cuda
def test_replay_advances_ffn_counters(graph):
    """On the card the runners' step is graphed: its first step runs
    eagerly, the next two capture, the rest replay; every kind advances
    the FFN's call counter by ``L``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    dev = torch.device("cuda", 0)
    cfg = _cfg("sorted", True)
    cfg.update(n_hid=128)   # the kernels' route takes rows of 128 or more
    sut = _build(cfg, graph, dev)
    step, _ = session.stepper(sut, dev)
    L = cfg["n_layers"]
    kinds = []
    loader = sut.loader(SEED, 2, dict(TRAFFIC, queue_size=4))
    with loader:
        it = iter(loader)
        for k in range(6):
            item, _ = next(it)
            calls = ffn_counts.calls
            counts = (sut.step.eager_steps, sut.step.captures)
            step(k, item)
            kinds.append("eager" if sut.step.eager_steps > counts[0]
                         else "capture" if sut.step.captures > counts[1]
                         else "replay")
            assert ffn_counts.calls - calls == L, kinds
    session._close(loader)
    torch.cuda.synchronize()
    assert kinds == ["eager", "capture", "capture", "replay", "replay",
                     "replay"]
