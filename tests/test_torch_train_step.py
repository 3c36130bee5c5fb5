"""The port's training step against the JAX package's, on the tiny preset.

Weights are carried across by ``pyhgt_tpu_torch.convert``; dropout is 0 on
both sides (the two frameworks cannot draw the same masks). Held against
the JAX package: the loss and every parameter gradient of
``loss_fn_single``; a 3-step AdamW trajectory of ``make_train_step`` under
the bench's optimizer (global-norm clip 0.25, weight decay 0.01 with the
no-decay mask, eps 1e-6, ``cosine_schedule(1e-3, 1000)``); the decay mask;
the schedules; the clip; the losses. The JAX side reaches its Pallas
kernels in interpret mode (f32 edges, ``seg_pallas`` on, so the port runs
the plain versions of both of its kernels).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pyhgt_tpu.flagship import build_flagship as jax_build
from pyhgt_tpu.train import optim as joptim
from pyhgt_tpu.train import step as jstep
from pyhgt_tpu_torch import bench
from pyhgt_tpu_torch.convert import (
    flax_to_state_dict, load_flax_params, named_to_flax,
)
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.train import optim, step
from test_torch_flagship import ROOT, _imported_modules

FLAGS = dict(dropout=0.0, seg_pallas=True)
N_STEPS = 3


@pytest.fixture(scope="module")
def shared():
    """Both flagships with the same weights, one batch, and the JAX side's
    loss-and-gradient and 3-step trajectory (each jitted once)."""
    jf = jax_build("tiny", **FLAGS)
    tf = build_flagship("tiny", device="cpu", **FLAGS)
    batch, labels = synth_flagship_batch(tf, 0)
    jse = jf.sort(batch)
    params = jax.jit(lambda key: jf.model.init(
        key, *jf.batch_args(batch), jf.em, se=jse))(jax.random.PRNGKey(0))
    args = (jax.random.PRNGKey(1), *jf.batch_args(batch), jse,
            jnp.asarray(labels))
    loss_fn = jf.loss_fn_single()
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params, *args)

    tx = joptim.make_optimizer(
        joptim.cosine_schedule(1e-3, 1000), weight_decay=0.01,
        clip_norm=0.25, params=params)
    state = jstep.TrainState.create(params, tx)
    jstep_fn = jstep.make_train_step(loss_fn, tx, donate=False)
    losses = []
    for _ in range(N_STEPS):
        state, loss = jstep_fn(state, *args)
        losses.append(float(loss))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(tf=tf, batch=batch, labels=labels, params=to_np(params),
                loss=float(jloss), grads=to_np(jgrads), losses=losses,
                final=to_np(state.params))


def _fresh(shared):
    """The port's flagship with the shared initial weights."""
    tf = build_flagship("tiny", device="cpu", **FLAGS)
    load_flax_params(tf.model, shared["params"])
    return tf


def test_loss_and_every_gradient_match_jax(shared):
    tf = _fresh(shared)
    batch = shared["batch"]
    loss = tf.loss(batch, tf.sort(batch), shared["labels"])
    loss.backward()
    # f32 on both sides; sums run in another order (see
    # tests/test_torch_edge_bwd.py): 3e-4 of each tensor's scale
    assert abs(loss.item() - shared["loss"]) <= 1e-5 * abs(shared["loss"])
    want = flax_to_state_dict(shared["grads"])
    got = {n: p.grad for n, p in tf.model.named_parameters()}
    assert got.keys() == want.keys()
    top = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        assert got[name] is not None and torch.isfinite(got[name]).all(), name
        scale = max(w.abs().max().item(), 1e-3 * top)
        err = (got[name] - w).abs().max().item()
        assert err <= 3e-4 * scale, (name, err, scale)
    # and back: the port's gradients exported in the flax layout
    back = named_to_flax(got)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_w = jax.tree_util.tree_leaves_with_path(shared["grads"])
    assert [p for p, _ in flat_b] == [p for p, _ in flat_w]
    assert all(b.shape == w.shape for (_, b), (_, w) in zip(flat_b, flat_w))


def test_three_adamw_steps_match_jax(shared):
    tf = _fresh(shared)
    batch = shared["batch"]
    state, train_step = bench.make_flagship_trainer(tf)
    args = tf.to_device(batch, tf.sort(batch), shared["labels"])
    losses = [float(train_step(*args)) for _ in range(N_STEPS)]
    assert state.step == N_STEPS
    np.testing.assert_allclose(losses, shared["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    final = flax_to_state_dict(shared["final"])
    init = flax_to_state_dict(shared["params"])
    # AdamW moves a parameter by about lr * g / (|g| + eps) per step: at
    # most lr = 1e-3, whatever the gradient's size. A gradient that differs
    # by d between the packages moves the update by about lr * d / (|g| +
    # eps), so leaves whose clipped gradient is near eps = 1e-6 amplify the
    # f32 differences of the backward. Seen: 2.0e-6 at worst and 3e-8 on
    # average after 3 steps. Bound: 1e-4 at worst (a thirtieth of the
    # largest possible move, N_STEPS * lr) and 1e-6 on average.
    worst = mean = 0.0
    for name, p in tf.model.named_parameters():
        diff = (p.detach() - final[name]).abs()
        worst, mean = max(worst, diff.max().item()), max(mean, diff.mean().item())
        moved = (final[name] - init[name]).abs().max().item()
        assert moved > 0, name
    assert worst <= 1e-4, worst
    assert mean <= 1e-6, mean


def test_decay_mask_marks_the_same_leaves(shared):
    mask = joptim._decay_mask(shared["params"])
    as_float = jax.tree_util.tree_map(lambda m: np.float32(m), mask)
    want = {k: bool(v) for k, v in flax_to_state_dict(as_float).items()}
    tf = shared["tf"]
    got = {n: optim.decays(n) for n, _ in tf.model.named_parameters()}
    assert got == want
    assert not got["gnn.convs.0.rel_pri"] and not got["clf.linear.bias"]
    assert got["gnn.convs.0.wq"] and got["clf.linear.weight"]
    groups = optim.make_optimizer(tf.model.named_parameters(),
                                  1e-3).inner.param_groups
    assert [g["weight_decay"] for g in groups] == [0.01, 0.0]
    assert sum(len(g["params"]) for g in groups) == len(got)
    assert len(groups[0]["params"]) == sum(got.values())


STEPS = [0, 1, 2, 7, 48, 49, 50, 51, 400, 999, 1000, 1001, 1500, 2600]
SCHEDULES = {
    "cosine": ("cosine_schedule", dict(lr=1e-3, period=1000)),
    "cosine-short": ("cosine_schedule",
                     dict(lr=5e-4, period=50, eta_min=1e-5)),
    "cosine-torch": ("cosine_torch_schedule",
                     dict(lr=1e-3, period=1000, start_step=1500)),
    "onecycle": ("onecycle_schedule", dict(max_lr=5e-4, total_steps=1001)),
    "onecycle-cos": ("onecycle_schedule",
                     dict(max_lr=1e-3, total_steps=200, pct_start=0.3,
                          anneal="cos")),
    "onecycle-tiny": ("onecycle_schedule", dict(total_steps=1)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    fn, kw = SCHEDULES[name]
    ours, theirs = getattr(optim, fn)(**kw), getattr(joptim, fn)(**kw)
    peak = kw.get("lr", kw.get("max_lr", 5e-4))
    for s in STEPS:
        # to 1e-6 of the schedule's peak, and 2e-5 of the value itself: the
        # JAX functions evaluate cos and the phase in f32 (seen: 8e-6 near a
        # phase's end), the port's in Python floats
        want = float(theirs(s))
        assert abs(ours(s) - want) <= 1e-6 * peak, (s, ours(s), want)
        assert ours(s) == pytest.approx(want, rel=2e-5), s


@pytest.mark.parametrize("norm", [0.1, 0.25, 3.0])
def test_global_norm_clip_matches_optax(norm):
    rng = np.random.default_rng(2)
    g = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,), ())]
    g = [x * norm / np.sqrt(sum((y ** 2).sum() for y in g)) for x in g]
    want, _ = optax.clip_by_global_norm(0.25).update(
        [jnp.asarray(x) for x in g], optax.EmptyState())
    ps = [torch.nn.Parameter(torch.zeros(x.shape)) for x in g]
    for p, x in zip(ps, g):
        p.grad = torch.tensor(x)
    before = optim.clip_by_global_norm_(ps, 0.25)
    assert before.item() == pytest.approx(norm, rel=1e-5)
    for p, w in zip(ps, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)
    after = np.sqrt(sum((p.grad.numpy() ** 2).sum() for p in ps))
    assert after == pytest.approx(min(norm, 0.25), rel=1e-5)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd", "adagrad"])
def test_optimizers_follow_optax_from_step_zero(name):
    """Five steps on a fixed sequence of gradients: the schedule is read at
    the count before the increment (the first update uses schedule(0)),
    decay skips the masked leaf, and each update rule is the library's."""
    rng = np.random.default_rng(4)
    shapes = {"w": (4, 3), "bias": (3,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 0.1
              for k, s in shapes.items()} for _ in range(5)]
    sched = dict(lr=1e-2, period=4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tx = joptim.make_optimizer(joptim.cosine_schedule(**sched),
                               weight_decay=0.1, clip_norm=0.25, params=jp,
                               name=name)
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = optim.make_optimizer(tp.items(), optim.cosine_schedule(**sched),
                               weight_decay=0.1, clip_norm=0.25, name=name)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    assert opt.count == 5
    for k in shapes:
        # adagrad: torch adds its eps outside the root, optax inside
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer(tp.items(), 1e-3, name="lamb")


@pytest.mark.parametrize("fn", ["nll_loss", "kl_div_loss"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_losses_match_jax(fn, masked):
    rng = np.random.default_rng(6)
    logp = np.log(rng.dirichlet(np.ones(7), size=9)).astype(np.float32)
    if fn == "nll_loss":
        target = rng.integers(0, 7, size=9).astype(np.int32)
    else:
        target = rng.dirichlet(np.ones(7), size=9).astype(np.float32)
        target[:, 2] = 0.0           # zero targets contribute nothing
        target[4] = 0.0              # an all-zero row
    mask = (rng.random(9) < 0.6).astype(np.float32) if masked else None
    want = getattr(jstep, fn)(jnp.asarray(logp), jnp.asarray(target),
                              None if mask is None else jnp.asarray(mask))
    got = getattr(step, fn)(torch.tensor(logp), torch.tensor(target),
                            None if mask is None else torch.tensor(mask))
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    if masked:   # an all-zero mask divides by 1, not by 0
        zero = getattr(step, fn)(torch.tensor(logp), torch.tensor(target),
                                 torch.zeros(9))
        assert zero.item() == 0.0


def test_train_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run("tiny", steps=1, warmup=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--preset", "tiny", "--steps", "1", "--warmup", "0"])
    out = bench.run("tiny", steps=1, warmup=1, device="cpu")
    # a CPU run never reports the chip's metric
    assert out["metric"] == "hgt_train_edges_per_s_cpu" and out["value"] > 0


def test_seeded_dropout_gives_the_same_loss_twice(shared):
    batch, labels = shared["batch"], shared["labels"]
    losses = []
    for seed in (3, 3, 4):
        tf = build_flagship("tiny", device="cpu", seed=seed, dropout=0.2)
        load_flax_params(tf.model, shared["params"])
        se = tf.sort(batch)
        losses.append([tf.loss(batch, se, labels).item() for _ in range(2)])
    assert losses[0] == losses[1]            # same seed, same masks
    assert losses[0] != losses[2]            # another seed, other masks
    assert losses[0][0] != losses[0][1]      # the stream moves on
    # eval mode drops nothing out
    a, b = tf.forward(batch, se), tf.forward(batch, se)
    assert torch.equal(a, b) and not tf.model.training


def test_new_modules_import_no_jax():
    files = [ROOT / "pyhgt_tpu_torch" / f for f in
             ("bench.py", "train/step.py", "train/optim.py", "convert.py")]
    banned = ("jax", "jaxlib", "flax", "optax", "pyhgt_tpu")
    for f in files:
        assert isinstance(f, pathlib.Path) and f.exists(), f
        bad = [m for m in _imported_modules(f) if m.split(".")[0] in banned]
        assert not bad, (f, bad)
