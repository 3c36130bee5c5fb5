"""The one-device train step replayed from CUDA graphs
(``pyhgt_tpu_torch.train.graph_step``), on the tiny flagship with dropout
on and the hand kernels' route: what keys a graph (the batch's
signature), which steps stay eager (the CPU, a hooked model), and on the
card, that a replayed step gives the eager step's numbers, returns its
own loss and counts the kernels it launched."""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.experiments import engine
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.ops import pallas_seg
from pyhgt_tpu_torch.train import optim
from pyhgt_tpu_torch.train.graph_step import (
    GraphedStep,
    _AdamWUpdate,
    _plain_adamw,
    hooked,
    signature,
)
from pyhgt_tpu_torch.train.loader import PrefetchLoader, map_arrays
from pyhgt_tpu_torch.train.step import make_train_step, nll_loss

FLAGS = dict(dropout=0.2, seg_pallas=True, edge_bf16=True,
             softmax_pallas=True)


def _flagship(device):
    return build_flagship("tiny", device=device, seed=0, **FLAGS)


def _loss_fn(fl):
    def loss(gen, nf, nmk, se, labels):
        fl.model.train()
        return nll_loss(fl.model(nf, nmk, se, fl.em_dev, generator=gen),
                        labels)
    return loss


def _host_item(fl, seed, labels_dtype=np.int32):
    """``(node_feat, node_mask, se, labels)`` of one synthetic batch, host
    arrays and CPU tensors (the loader's staged form)."""
    batch, labels = synth_flagship_batch(fl, seed)
    se = fl.sort(batch).to(torch.device("cpu"))
    return (np.asarray(batch.node_feat), np.asarray(batch.node_mask), se,
            labels.astype(labels_dtype))


def _on(device, item):
    return map_arrays(lambda a: torch.as_tensor(a).to(device), item)


def _tx(model):
    return optim.make_optimizer(model.named_parameters(),
                                optim.cosine_schedule(1e-3, 8),
                                weight_decay=0.01, clip_norm=0.25)


# ------------------------------------------------------------- the CPU


@pytest.fixture(scope="module")
def cpu_batch():
    fl = _flagship("cpu")
    return _on("cpu", _host_item(fl, 0))


def _changed(name, nf, nmk, se, labels):
    """The batch with one thing changed that a graph bakes in."""
    aux = se.pseg_src
    if name == "shape":
        nf = nf[:, :-1]
    elif name == "dtype":
        labels = labels.long()
    elif name == "w":
        se = dataclasses.replace(se, pseg_src=dataclasses.replace(
            aux, w=aux.w * 2))
    elif name == "window":
        se = dataclasses.replace(se, pseg_src=dataclasses.replace(
            aux, window=True))
    elif name == "dead_rows":
        se = dataclasses.replace(se, pseg_src=dataclasses.replace(
            aux, dead_rows=True))
    elif name == "tiles":
        se = dataclasses.replace(se, pseg_src=dataclasses.replace(
            aux, loc=aux.loc[:-1]))
    elif name == "missing_aux":
        se = dataclasses.replace(se, ptab_src=None, pseg_tab=None)
    return nf, nmk, se, labels


@pytest.mark.parametrize("name", ["shape", "dtype", "w", "window",
                                  "dead_rows", "tiles", "missing_aux"])
def test_signature_differs_where_a_graph_would(cpu_batch, name):
    """A shape, a dtype or a kernel aux's host field (``w``, ``window``,
    ``dead_rows``, the tile count, an aux left out) changes the key; the
    same layout with other values and other tensors keeps it."""
    key, tensors = signature(cpu_batch)
    again, others = signature(tuple(map_arrays(torch.clone, cpu_batch)))
    assert key is not None and again == key
    assert len(tensors) == len(others) > 10
    assert all(a is not b for a, b in zip(tensors, others))
    assert signature(_changed(name, *cpu_batch))[0] != key


def test_signature_refuses_host_arrays(cpu_batch):
    """A numpy leaf would be copied to the card inside the step: no key."""
    nf, nmk, se, labels = cpu_batch
    assert signature((nf.numpy(), nmk, se, labels))[0] is None


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms on one thread: on the CPU the
    backward of an indexed read adds its rows from several threads as
    they are scheduled, which moves a gradient by a few ulp from one call
    to the next."""
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


@_deterministic()
def test_cpu_step_stays_eager():
    """On the CPU every step is eager, ``make_train_step``'s to the bit,
    and the counters say so; ``_train_epoch`` reports a graph share of 0
    and its log line says it."""
    fl_a, fl_b = _flagship("cpu"), _flagship("cpu")
    step_a = GraphedStep(_loss_fn(fl_a), _tx(fl_a.model), fl_a.model)
    step_b = make_train_step(_loss_fn(fl_b), _tx(fl_b.model))
    items = [_on("cpu", _host_item(fl_a, s)) for s in range(3)]
    gen = torch.Generator()
    for k, item in enumerate(items):
        gen.manual_seed(k)
        la = step_a(gen, *item)
        gen.manual_seed(k)
        lb = step_b(gen, *item)
        assert torch.equal(la, lb)
        assert step_a.grad_norm is not None
    assert (step_a.eager_steps, step_a.captures, step_a.replays) == (3, 0, 0)
    assert step_a.stream is None
    for pa, pb in zip(fl_a.model.parameters(), fl_b.model.parameters()):
        assert torch.equal(pa, pb)

    cfg = ExperimentConfig(n_batch=2, repeat=1)
    loop = iter(types.SimpleNamespace(args=it, n_edges=1, overflow=0)
                for it in items)
    _, _, _, timing = engine._train_epoch(step_a, loop, cfg, 0, gen,
                                          torch.device("cpu"),
                                          lambda it: it.args)
    assert timing["graph_share"] == 0.0
    assert step_a.eager_steps == 5
    assert "graph share 0.00" in engine._timing_text(timing)


HOOKS = {
    "forward_pre": lambda m: m.gnn.convs[0].register_forward_pre_hook(
        lambda mod, args: None),
    "forward": lambda m: m.clf.register_forward_hook(
        lambda mod, args, out: None),
    "backward": lambda m: m.gnn.register_full_backward_hook(
        lambda mod, gi, go: None),
    "global_forward": lambda m: (
        torch.nn.modules.module.register_module_forward_hook(
            lambda mod, args, out: None)),
}


@pytest.mark.parametrize("kind", sorted(HOOKS))
def test_hooked_model_is_seen(kind):
    """A hook on the model, on one of its modules or on every module keeps
    the step eager (a replay would skip it); removing it lifts that."""
    fl = _flagship("cpu")
    assert not hooked(fl.model)
    handle = HOOKS[kind](fl.model)
    try:
        assert hooked(fl.model)
    finally:
        handle.remove()
    assert not hooked(fl.model)


@torch.no_grad()
def test_recorded_update_is_torch_adamw():
    """The update a graph records (run here as it is recorded, on the CPU)
    is torch's AdamW step under the schedule: the same moments and step
    counts, and each parameter within an ulp of itself or of its update
    per step (only the last operation is ordered otherwise); the state is
    made as torch's first step makes it, and the bias-free group takes no
    decay."""
    gen = torch.Generator().manual_seed(0)
    shapes = {"w": (500, 300), "bias": (30,), "gnn.adapt_w": (7, 5)}
    ref = [(k, torch.nn.Parameter(torch.randn(s, generator=gen) * 0.01))
           for k, s in shapes.items()]
    mine = [(k, torch.nn.Parameter(p.clone())) for k, p in ref]
    tx_ref, tx = (optim.make_optimizer(n, optim.cosine_schedule(1e-3, 8),
                                       clip_norm=None) for n in (ref, mine))
    assert _plain_adamw(tx.inner)
    scalars = torch.zeros(len(tx.inner.param_groups), 3)
    drift = [torch.zeros(p.shape) for _, p in ref]
    for k in range(6):
        before = [p.clone() for _, p in ref]
        for (_, p), (_, q) in zip(ref, mine):
            p.grad = torch.randn(p.shape, generator=gen)
            q.grad = p.grad.clone()
        tx_ref.step()
        update = _AdamWUpdate(tx.inner, scalars, make_state=True)
        update.advance(tx.schedule(tx.count))
        update.record()
        tx.count += 1
        for d, b, (_, p), (_, q) in zip(drift, before, ref, mine):
            d += 2.0 ** -23 * torch.maximum(b.abs(), (p - b).abs()) * 2
            assert bool(((p - q).abs() <= d).all())
            sp, sq = tx_ref.inner.state[p], tx.inner.state[q]
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sp[key], sq[key])
    assert float(tx.inner.state[mine[0][1]]["step"]) == 6


def test_update_refuses_a_parameter_without_state():
    """A parameter with a gradient but no AdamW state yet (it was never
    updated eagerly) cannot be recorded: the capture is refused."""
    p = torch.nn.Parameter(torch.zeros(3))
    tx = optim.make_optimizer([("w", p)], 1e-3)
    p.grad = torch.ones(3)
    with pytest.raises(Exception, match="no AdamW state"):
        _AdamWUpdate(tx.inner, torch.zeros(2, 3))


# ------------------------------------------------------------- the card

N_SAME = 8  # steps on batches of one signature


def _kernel_counts():
    return (pallas_seg.live_partials.launches,
            pallas_seg.live_partials_pair.launches,
            pallas_seg.live_partials_pair.window_launches,
            pallas_seg.segment_softmax_partials.launches)


def _run(step, fl, items, hook_at=None):
    """Steps on ``items`` (device tuples), each seeded as the runners
    seed theirs; per step: the loss tensor, its value, the gradient norm,
    the hand kernels' launches, and what the step did (``eager``,
    ``capture``, ``replay``, from the graphed step's counters)."""
    gen = torch.Generator(device="cuda")
    out = []
    for k, item in enumerate(items):
        fired = []
        handle = None
        if k == hook_at:
            handle = fl.model.gnn.convs[0].register_forward_pre_hook(
                lambda mod, args: fired.append(1))
        before = _kernel_counts()
        captures, replays = step.captures, step.replays
        gen.manual_seed(1000 + k)
        loss = step(gen, *item)
        kind = ("capture" if step.captures > captures
                else "replay" if step.replays > replays else "eager")
        if handle is not None:
            handle.remove()
        out.append(dict(loss=loss, value=float(loss),
                        norm=float(step.grad_norm), kind=kind,
                        hook_fired=bool(fired),
                        launches=tuple(a - b for a, b in
                                       zip(_kernel_counts(), before))))
    torch.cuda.synchronize()
    return out, [p.detach().clone() for p in fl.model.parameters()]


@pytest.fixture(scope="module")
def card_runs():
    """The same steps three times on the card: twice eagerly (graphed
    steps given fresh device copies of the items, which lie in no input
    slot, so every step runs eagerly, with the optimizer in the form the
    graphs use), once through a graphed step fed by a PrefetchLoader
    whose copies land in its input slots. Steps 0-7 share a signature
    (step 6 with a hook on the model); step 8's labels are int64, another
    signature, given as a fresh device copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    host = [_host_item(_flagship("cpu"), s) for s in range(N_SAME)]
    odd = _host_item(_flagship("cpu"), N_SAME, labels_dtype=np.int64)
    runs = {}
    for name in ("eager_a", "eager_b"):
        fl = _flagship("cuda")
        step = GraphedStep(_loss_fn(fl), _tx(fl.model), fl.model)
        runs[name] = _run(step, fl,
                          [_on("cuda", it) for it in host + [odd]],
                          hook_at=6)
        assert step.eager_steps == N_SAME + 1
    fl = _flagship("cuda")
    step = GraphedStep(_loss_fn(fl), _tx(fl.model), fl.model)
    made = iter(range(10 ** 6))
    with PrefetchLoader(lambda rng: host[next(made) % N_SAME], n_workers=1,
                        seed=0, device="cuda") as loader:
        runs["graphed"] = _run(step, fl,
                               _Fed(iter(loader), N_SAME, _on("cuda", odd)),
                               hook_at=6)
    runs["step"] = step
    return runs


class _Fed:
    """The loader's first ``n`` items, taken one at a time as the steps
    ask for them (an item is valid until the next is taken), then
    ``last``."""

    def __init__(self, it, n, last):
        self.it, self.n, self.last = it, n, last

    def __iter__(self):
        for _ in range(self.n):
            yield next(self.it)
        yield self.last


def _close_to(got, want, other):
    """``got`` within what two eager runs differ (``want`` against
    ``other``), and at least a millionth of the scale: a replayed update
    orders its last operation otherwise, which moves a parameter by an
    ulp at most, and the steps after carry that on."""
    got, want, other = (torch.as_tensor(x, dtype=torch.float64)
                        for x in (got, want, other))
    spread = (want - other).abs().max()
    scale = want.abs().max()
    tol = max(4 * float(spread), 1e-6 * float(scale))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
def test_graphed_step_matches_eager(card_runs):
    """Losses, gradient norms and parameters of the graphed run agree
    with the eager run within what two eager runs differ, over steps that
    run eagerly, capture and replay with the schedule running and the
    dropout masks drawn from the reseeded generator."""
    (ea, pa), (eb, pb), (g, pg) = (card_runs[k] for k in
                                   ("eager_a", "eager_b", "graphed"))
    kinds = [s["kind"] for s in g]
    assert kinds == ["eager", "capture", "capture", "replay", "replay",
                     "replay", "eager", "replay", "eager"]
    for key in ("value", "norm"):
        _close_to([s[key] for s in g], [s[key] for s in ea],
                  [s[key] for s in eb])
    for x, y, z in zip(pg, pa, pb):
        _close_to(x, y, z)


@pytest.mark.cuda
def test_each_step_returns_its_own_loss(card_runs):
    """Every step's loss is a tensor of its own that keeps its value
    after later steps (a replay's loss is copied out of the graph)."""
    g, _ = card_runs["graphed"]
    assert len({s["loss"].data_ptr() for s in g}) == len(g)
    assert [float(s["loss"]) for s in g] == [s["value"] for s in g]
    assert len({s["value"] for s in g}) == len(g)


@pytest.mark.cuda
def test_replays_count_the_kernels_they_launch(card_runs):
    """A replay advances the hand kernels' launch counters by what its
    capture launched: every step of the signature counts what an eager
    step counts."""
    g, _ = card_runs["graphed"]
    e, _ = card_runs["eager_a"]
    assert g[0]["launches"][0] > 0
    assert all(s["launches"] == e[k]["launches"] for k, s in enumerate(g))


@pytest.mark.cuda
def test_hook_and_new_signature_run_eagerly(card_runs):
    """With a hook on the model the step runs eagerly (the hook fires);
    the next step replays again; a batch of another signature runs
    eagerly and captures nothing, at most two graphs in all."""
    g, _ = card_runs["graphed"]
    step = card_runs["step"]
    assert g[6]["kind"] == "eager" and g[6]["hook_fired"]
    assert g[7]["kind"] == "replay"
    assert g[8]["kind"] == "eager"
    # a capture's step is its graph's first replay
    assert (step.captures, step.replays, step.eager_steps) == (2, 6, 3)
