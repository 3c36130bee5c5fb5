"""The training-step extras of the port against the JAX package's.

- ``fused_adamw`` (the flattened-vector AdamW) against JAX's
  ``fused_adamw`` and against the port's per-tensor chain over 7 steps of
  JAX's toy tree with the clip firing: rtol 1e-5 / atol 1e-6 against JAX,
  rtol 2e-6 / atol 2e-7 against the chain (the bound JAX's own
  ``tests/test_train.py`` holds its fused form to); its ``TypeError`` on a
  non-f32 parameter and ``make_optimizer``'s fallback, as JAX's;
- ``make_train_step_acc`` on JAX's regression toy (rtol 1e-6), and A = 1
  against the plain step;
- ``bf16_param_cast``: the cast leaf set equals JAX's ``_decay_mask`` leaf
  for leaf (through ``convert``'s name map), and the tiny flagship's loss
  and gradients under ``param_bf16`` match JAX's ``param_bf16`` within
  rtol 1e-5 on the loss and 3e-4 of each tensor's scale on the gradients
  (the f32 tolerance of ``tests/test_torch_edge_bwd.py``), every gradient
  f32. The gradient of a cast leaf is a bf16 quantity in both packages:
  what reaches the bf16 bank rounds to bf16 (2^-8 of its magnitude at
  most) once per rounding point, and the packages round at different
  points (the port once per bank and forward; the JAX package per read of
  the bank, and its CPU compiler keeps excess precision in places): the
  cast leaves are held within 2^-7 of their tensor's scale (two roundings
  of contributions up to that scale), measured up to 5.2e-3 of scale at
  ``gnn.convs.1.rel_msg``; every other leaf within 3e-4 of scale;
- ``remat``: the tiny flagship's gradients with ``remat`` equal its
  gradients without (both under torch's deterministic algorithms: within
  1e-6 of scale) and match JAX's ``remat=True`` within 3e-4 of scale, on
  the sorted and the segment edge paths;
- ``utils.synth.synth_labels`` equals JAX's for a seed, and the package's
  subpackages load on first attribute access as JAX's do;
- a ``fused_opt`` run's checkpoint restores its moments exactly into the
  flat buffers, and ``run_ogbn`` for one epoch plus a resumed epoch under
  ``--fused_opt --param_bf16 --remat`` with tp 2 and with pp 2 (one
  spawned 2-rank gloo world) matches the same in one process (parameters
  and moments within 1e-4 of their scale, as
  ``tests/test_torch_tensor_parallel.py`` holds its resume).

Weights are carried by ``pyhgt_tpu_torch.convert``; dropout is 0 on both
sides; the JAX flagship runs the tiny preset's default flags (no Pallas
kernel on its path), the port its plain path on the CPU.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyhgt_tpu.flagship import build_flagship as jax_build
from pyhgt_tpu.train import optim as joptim
from pyhgt_tpu.train import step as jstep
from pyhgt_tpu_torch.convert import flax_to_state_dict, load_flax_params
from pyhgt_tpu_torch.experiments import engine
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.parallel.distributed import spawn
from pyhgt_tpu_torch.train import optim, step
from pyhgt_tpu_torch.train.checkpoint import (
    load_checkpoint,
    named_optimizer_state,
)
from test_torch_tensor_parallel import _resume_run
from test_torch_parallel_runs import _run, _single_model, run_cfg, toy_graph

# the knobs every run of the resume cases takes
KNOBS = dict(fused_opt=True, param_bf16=True, remat=True)
GRAD_TOL = 3e-4
# (edge_impl) of the remat cases
PATHS = ("sorted", "segment")


def _toy_params(rng):
    return {
        "layer": {"wq": rng.normal(size=(16, 8)).astype(np.float32),
                  "bq": rng.normal(size=(8,)).astype(np.float32),
                  "skip": rng.normal(size=(3,)).astype(np.float32)},
        "head": rng.normal(size=(8, 4)).astype(np.float32),
    }


def _toy_named(p):
    return [(n, torch.nn.Parameter(torch.tensor(a))) for n, a in (
        ("layer.wq", p["layer"]["wq"]), ("layer.bq", p["layer"]["bq"]),
        ("layer.skip", p["layer"]["skip"]), ("head", p["head"]))]


def _toy_loss(named):
    t = dict(named)
    return ((torch.tanh(t["layer.wq"]) ** 2).sum()
            + 50.0 * (t["layer.bq"] ** 2).sum()      # big grads: clip fires
            + (t["layer.skip"] ** 2).sum() + (t["head"] ** 2).sum())


def test_fused_adamw_matches_jax_and_the_chain():
    p0 = _toy_params(np.random.default_rng(0))
    sched_kw = dict(weight_decay=0.05, clip_norm=0.1)

    def jax_loss(p, key):
        return (jnp.sum(jnp.tanh(p["layer"]["wq"]) ** 2)
                + 50.0 * jnp.sum(p["layer"]["bq"] ** 2)
                + jnp.sum(p["layer"]["skip"] ** 2) + jnp.sum(p["head"] ** 2))

    params = jax.tree_util.tree_map(jnp.asarray, p0)
    tx = joptim.make_optimizer(joptim.cosine_schedule(1e-2, 50), fused=True,
                               params=params, **sched_kw)
    state = jstep.TrainState.create(params, tx)
    jax_step = jstep.make_train_step(jax_loss, tx, donate=False)
    runs = {}
    for fused in (True, False):
        named = _toy_named(p0)
        opt = optim.make_optimizer(named, optim.cosine_schedule(1e-2, 50),
                                   fused=fused, **sched_kw)
        assert isinstance(opt.inner, optim.FlatAdamW) == fused
        runs[fused] = (named, opt)
    key = jax.random.key(0)
    for _ in range(7):
        state, _ = jax_step(state, key)
        for named, opt in runs.values():
            opt.zero_grad()
            _toy_loss(named).backward()
            opt.step()
        want = {"layer.wq": state.params["layer"]["wq"],
                "layer.bq": state.params["layer"]["bq"],
                "layer.skip": state.params["layer"]["skip"],
                "head": state.params["head"]}
        fused = dict(runs[True][0])
        chain = dict(runs[False][0])
        for n, w in want.items():
            got = fused[n].detach().numpy()
            np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5,
                                       atol=1e-6, err_msg=n)
            np.testing.assert_allclose(got, chain[n].detach().numpy(),
                                       rtol=2e-6, atol=2e-7, err_msg=n)
    # the moments in AdamW's per-parameter form, views of the flat buffers
    opt = runs[True][1]
    for p in opt.params:
        st = opt.inner.state[p]
        assert st["exp_avg"].shape == p.shape and float(st["step"]) == 7
        assert st["exp_avg"].untyped_storage().data_ptr() == \
            opt.inner._mu.untyped_storage().data_ptr()


def test_fused_adamw_refuses_non_f32_as_jax_does():
    with pytest.raises(TypeError, match="all-f32"):
        joptim.fused_adamw(1e-2, {"w": jnp.ones((2,), jnp.bfloat16)})
    named = [("w", torch.nn.Parameter(torch.ones(2, dtype=torch.bfloat16)))]
    with pytest.raises(TypeError, match="all-f32"):
        optim.fused_adamw(named, 1e-2)
    # make_optimizer falls back to the per-tensor chain, with a warning
    with pytest.warns(RuntimeWarning, match="falls back"):
        opt = optim.make_optimizer(named, 1e-2, fused=True)
    assert type(opt.inner) is torch.optim.AdamW


def test_train_step_acc_matches_jax():
    import optax

    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(6, 1)).astype(np.float32)
    xs = rng.normal(size=(2, 16, 6)).astype(np.float32)  # A = 2
    ys = np.einsum("abc,cd->abd", xs, w_true)
    w0 = rng.normal(size=(6, 1)).astype(np.float32)
    kw = dict(weight_decay=0.01, clip_norm=0.5)

    def jax_loss(p, key, x, y):
        return jnp.mean((x @ p["w"] - y) ** 2)

    params = {"w": jnp.asarray(w0)}
    tx = joptim.make_optimizer(1e-2, params=params, **kw)
    losses, grads = zip(*[jax.value_and_grad(jax_loss)(params, None, xs[i],
                                                        ys[i])
                          for i in range(2)])
    g_mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)
    upd, _ = tx.update(g_mean, tx.init(params), params)
    want = np.asarray(optax.apply_updates(params, upd)["w"])

    def torch_loss(gen, x, y):
        return ((x @ w - y) ** 2).mean()

    w = torch.nn.Parameter(torch.tensor(w0))
    opt = optim.make_optimizer([("w", w)], 1e-2, **kw)
    loss = step.make_train_step_acc(torch_loss, opt)(
        None, torch.tensor(xs), torch.tensor(ys))
    np.testing.assert_allclose(w.detach().numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(sum(losses) / 2),
                               rtol=1e-6)
    assert opt.count == 1
    # A = 1 is the plain step
    outs = []
    for acc in (True, False):
        w = torch.nn.Parameter(torch.tensor(w0))
        opt = optim.make_optimizer([("w", w)], 1e-2, **kw)
        if acc:
            loss = step.make_train_step_acc(torch_loss, opt)(
                torch.Generator().manual_seed(3), torch.tensor(xs[:1]),
                torch.tensor(ys[:1]))
        else:
            loss = step.make_train_step(torch_loss, opt)(
                None, torch.tensor(xs[0]), torch.tensor(ys[0]))
        outs.append((float(loss), w.detach().numpy().copy()))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-6)


def test_synth_labels_and_lazy_subpackages_match_jax():
    import pyhgt_tpu
    import pyhgt_tpu_torch
    from pyhgt_tpu.utils.synth import synth_labels as jax_labels
    from pyhgt_tpu_torch.utils.synth import synth_labels

    for seed in (0, 5):
        want = jax_labels(None, 40, 7, np.random.default_rng(seed))
        got = synth_labels(None, 40, 7, np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(synth_labels(None, 9, 3),
                                  jax_labels(None, 9, 3))
    for name in ("models", "ops", "tasks", "train", "parallel", "datasets",
                 "experiments", "flagship"):
        assert getattr(pyhgt_tpu_torch, name).__name__ == \
            f"pyhgt_tpu_torch.{name}"
        assert getattr(pyhgt_tpu, name).__name__ == f"pyhgt_tpu.{name}"
    with pytest.raises(AttributeError):
        pyhgt_tpu_torch.not_a_subpackage


def _jax_flagship(**knobs):
    """JAX's tiny flagship under ``knobs``, its seed-0 initial weights, and
    the loss and gradients of its training loss (jitted once)."""
    jf = jax_build("tiny", dropout=0.0, **knobs)
    tf = build_flagship("tiny", device="cpu", dropout=0.0)
    batch, labels = synth_flagship_batch(tf, 0)
    se = jf.sort(batch)
    params = jax.jit(lambda key: jf.model.init(
        key, *jf.batch_args(batch), jf.em, se=se))(jax.random.key(0))
    loss, grads = jax.jit(jax.value_and_grad(jf.loss_fn_single()))(
        params, jax.random.key(1), *jf.batch_args(batch), se,
        jnp.asarray(labels))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), float(loss), flax_to_state_dict(to_np(grads))


def _port_grads(params, **knobs):
    tf = build_flagship("tiny", device="cpu", dropout=0.0, **knobs)
    load_flax_params(tf.model, params)
    batch, labels = synth_flagship_batch(tf, 0)
    loss = tf.loss(batch, tf.sort(batch), labels)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in tf.model.named_parameters()}


def _close_grads(got, want, tol, rounded=()):
    """Each gradient within ``tol`` of its tensor's scale; those named in
    ``rounded`` (bf16 quantities in both packages) within 2^-7 of it."""
    assert got.keys() == want.keys()
    top = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        g = got[name]
        assert g is not None and g.dtype == torch.float32, name
        assert torch.isfinite(g).all(), name
        scale = max(w.abs().max().item(), 1e-3 * top)
        err = (g - w).abs().max().item()
        bound = (2.0 ** -7 if name in rounded else tol) * scale
        assert err <= bound, (name, err, scale)


def test_param_bf16_matches_jax():
    params, jloss, jgrads = _jax_flagship(param_bf16=True)
    # the cast leaf set is JAX's decay mask, leaf for leaf
    mask = flax_to_state_dict(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32),
        joptim._decay_mask(params), params))
    tf = build_flagship("tiny", device="cpu")
    cast = optim.bf16_param_cast(tf.model.named_parameters())
    assert cast.keys() == mask.keys()
    for name, t in cast.items():
        want = bool(mask[name].reshape(-1)[0])
        assert (t.dtype == torch.bfloat16) == want, name
        assert t.dtype in (torch.bfloat16, torch.float32), name
    loss, grads = _port_grads(params, param_bf16=True)
    assert loss == pytest.approx(jloss, rel=1e-5)
    _close_grads(grads, jgrads, GRAD_TOL,
                 {n for n, t in cast.items() if t.dtype == torch.bfloat16})


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms. On the CPU the backward of an
    indexed read (``index_put`` with accumulate) otherwise adds its rows
    from several threads as they are scheduled, which moves a gradient by
    a few ulp from one call to the next in the same process."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


@pytest.mark.parametrize("edge_impl", PATHS)
def test_remat_matches_no_remat_and_jax(edge_impl):
    params, jloss, jgrads = _jax_flagship(remat=True, edge_impl=edge_impl)
    with _deterministic():
        loss, grads = _port_grads(params, remat=True, edge_impl=edge_impl)
        loss0, grads0 = _port_grads(params, edge_impl=edge_impl)
    assert loss == loss0
    _close_grads(grads, grads0, 1e-6)
    assert loss == pytest.approx(jloss, rel=1e-5)
    _close_grads(grads, jgrads, GRAD_TOL)


def _state_np(state):
    named = list(state.model.named_parameters())
    moments = {n: {k: v.detach().numpy().copy() for k, v in st.items()
                   if torch.is_tensor(v) and v.dim()}
               for n, st in named_optimizer_state(state.optimizer,
                                                  named).items()}
    return {n: p.detach().numpy().copy() for n, p in named}, moments


def test_fused_checkpoint_restores_its_moments(tmp_path):
    graph = toy_graph()
    cfg = run_cfg("ogbn", None, str(tmp_path)).replace(
        task_name="fused_ckpt", n_epoch=1, **KNOBS)
    res = _run("ogbn", cfg, graph)
    params, moments = _state_np(res["state"])
    assert isinstance(res["state"].optimizer.inner, optim.FlatAdamW)
    model = _single_model("ogbn", cfg, graph)
    state = load_checkpoint(str(tmp_path / "fused_ckpt_hgt_latest"),
                            step.TrainState(model, engine.make_tx(
                                cfg, model.named_parameters(), 2)))
    assert isinstance(state.optimizer.inner, optim.FlatAdamW)
    assert state.step == 2
    got_params, got_moments = _state_np(state)
    assert got_moments.keys() == moments.keys() and moments
    for n, st in moments.items():
        np.testing.assert_array_equal(got_params[n], params[n])
        for k, v in st.items():
            np.testing.assert_array_equal(got_moments[n][k], v)
    # the loaded moments are still the flat buffers' views
    inner = state.optimizer.inner
    mu = inner._mu.untyped_storage().data_ptr()
    assert all(st["exp_avg"].untyped_storage().data_ptr() == mu
               for st in inner.state.values())
    assert float(inner._step) == 2


def _extras_world(rank, world, tmp):
    return {mode: _resume_run(tmp, f"extras_{mode}", **knobs, **KNOBS)
            for mode, knobs in (("tp", dict(tp=2)),
                                ("pp", dict(pp=2, pp_micro=1)))}


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """The resumed runs under tp 2 and pp 2 (rank 0's state) and the same
    in one process, every run under ``KNOBS``."""
    tmp = str(tmp_path_factory.mktemp("extras_runs"))
    ranks = spawn(_extras_world, 2, tmp)
    return ranks[0], _resume_run(tmp, "extras_single", **KNOBS)


def _close_scaled(got, want, tol, what):
    scale = max(max(float(np.abs(v).max()) for v in want.values()), 1e-6)
    for n, w in want.items():
        err = float(np.abs(got[n] - w).max())
        assert err <= tol * scale, (what, n, err, scale)


@pytest.mark.parametrize("mode", ["tp", "pp"])
def test_extras_resume_under_parallel_matches_one_process(resumed, mode):
    par, single = resumed
    params, moments, step_n, epochs = par[mode]
    params1, moments1, step1, epochs1 = single
    assert step_n == step1 == 4 and epochs == epochs1 == 1
    assert params.keys() == params1.keys() == moments.keys() \
        == moments1.keys()
    _close_scaled(params, params1, 1e-4, f"{mode} params")
    for k in ("exp_avg", "exp_avg_sq"):
        _close_scaled({n: m[k] for n, m in moments.items()},
                      {n: m[k] for n, m in moments1.items()}, 1e-4,
                      f"{mode} {k}")
