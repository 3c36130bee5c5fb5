"""Tensor parallelism (tp) of the port against the JAX package's
single-device step, as ``tests/test_parallel.py`` holds JAX's dp x tp, and
resume under tp and pp.

The tiny flagship with the JAX package's initial weights (carried by
``convert``, then cut by ``shard_params`` through ``shard_model``), dropout
0 and ``seg_pallas=True`` (the kernels' plain versions on the CPU). tp = 2
trains on the batch of seed 0 and dp 2 x tp 2 (four ranks) on seeds 0 and
1; the reference is the JAX package's ``loss_fn_single`` and one update of
the bench's optimizer (AdamW, global-norm clip 0.25, weight decay 0.01,
``cosine_schedule(1e-3, 1000)``) on the mean loss, the ``REFS`` scheme of
``tests/test_torch_parallel.py``. Tolerances: the loss within 1e-5 of its
value; every gradient, gathered over the model group, within 1e-4 of its
tensor's scale (max |g|); every updated parameter, gathered, within 1e-4 of
the parameters' scale (max |p| over the model; that file says why the
update's tolerance is on the model's scale). Every model rank holds the
same replicated parameters after the step, bit for bit.

Also: the port's split axis of every parameter equals JAX's
``param_shardings`` on a ``make_mesh(n_data=1, n_model=2)`` of the
conftest's virtual devices; ``shard_params`` then ``gather_params`` is the
identity; the segment edge path and DenseHGT under tp 2 against the port's
single process on the same weights and batch (loss 1e-5, gradients 1e-4 of
scale; ``tests/test_torch_convs.py`` holds that process to JAX); each
runner under tp 2 and dp 2 x tp 2 on ``tests/test_torch_parallel_runs.py``'s
toy graph (finite losses, the same on every rank, a checkpoint that loads
in a single process with its optimizer state); and resume: ``run_ogbn``
for 1 epoch then a resumed epoch under tp 2, and under pp 2, against the
same two runs in one process (parameters and AdamW moments within 1e-4 of
their scale, the step equal). The loader restarts its seed on a resume, as
the JAX runners' does, so the resumed epoch trains on the first epoch's
items: two straight epochs would train on others, and the single process's
own resume (which restores the optimizer) is the reference; pp runs one
microbatch a step (``pp_micro`` 1), so each of its steps trains on the
single process's item. An optimizer restarted afresh moves each parameter
by about the learning rate (1e-2 here) and resets the moments, far past
these tolerances.

Each world is spawned once (gloo on the CPU).
"""

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch import bench
from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.convert import flax_to_state_dict, load_flax_params
from pyhgt_tpu_torch.experiments import engine
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.parallel import mesh as pmesh
from pyhgt_tpu_torch.parallel.distributed import spawn
from pyhgt_tpu_torch.parallel.spmd import dp_value_and_grad, make_tp_norm
from pyhgt_tpu_torch.train.checkpoint import (
    load_checkpoint,
    named_optimizer_state,
)
from pyhgt_tpu_torch.train.step import TrainState, nll_loss
from test_torch_parallel_runs import RUNNERS, _run, run_cfg, toy_graph

LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-4
FLAGS = dict(dropout=0.0, seg_pallas=True)
REFS = {"tp": (0,), "dp_tp": (0, 1)}
# the alternate paths held to the single process: (conv_name, edge_impl)
PATHS = {"segment": ("hgt", "segment"), "dense_hgt": ("dense_hgt", "sorted")}


def _flagship(p_np):
    fl = build_flagship("tiny", device="cpu", **FLAGS)
    load_flax_params(fl.model, p_np)
    return fl


def _full(named, mesh):
    """Each tensor of ``named`` joined over the model group (numpy)."""
    axes = pmesh.param_shardings(named)
    return {n: pmesh.join_along(t.detach(), axes[n], mesh).numpy().copy()
            for n, t in named}


def _tp_step(p_np, mesh):
    """One flagship step on this rank's slices: the loss, the gathered
    gradients and updated parameters, and this rank's replicated
    parameters after the update."""
    fl = _flagship(p_np)
    fl.model = pmesh.shard_model(fl.model, mesh)
    named = list(fl.model.named_parameters())
    opt = bench._optimizer(named)
    opt.norm_fn = make_tp_norm(named, mesh)
    batch, labels = synth_flagship_batch(fl, mesh.index(pmesh.DATA_AXIS))
    args = fl.to_device(batch, fl.sort(batch), labels)
    loss = dp_value_and_grad(fl.loss, opt.params, mesh)(*args)
    grads = _full([(n, p.grad) for n, p in named], mesh)
    opt.step()
    axes = pmesh.param_shardings(named)
    rep = {n: p.detach().numpy().copy() for n, p in named if axes[n] is None}
    return float(loss), grads, _full(named, mesh), rep


def _path_model(conv_name, edge_impl, fl):
    cfg = ExperimentConfig(
        n_hid=fl.cfg.n_hid, n_heads=fl.cfg.n_heads, n_layers=2,
        batch_size=fl.cfg.n_seed, dropout=0.0, seg_pallas=True,
        prev_norm=True, last_norm=True, conv_name=conv_name,
        edge_impl=edge_impl, calibrate_caps=False)
    return engine.node_classifier(cfg, fl.layout, fl.cfg.in_dim,
                                  fl.cfg.n_classes, head_mode="seeds")


def _path_step(name, mesh):
    """The loss and the gathered gradients of one step of ``name``'s model
    (tp over ``mesh``) and of the same model in one process."""
    fl = build_flagship("tiny", device="cpu", **FLAGS)
    full = _path_model(*PATHS[name], fl)
    batch, labels = synth_flagship_batch(fl, 0)
    b, se, y = fl.to_device(batch, fl.sort(batch), labels)
    edges = engine.raw_edges(full, batch, torch.device("cpu"))
    out = {}
    for tag, model in (("single", full),
                       ("tp", pmesh.shard_model(full, mesh))):
        model.train()
        loss = nll_loss(model(b.node_feat, b.node_mask, se, fl.em_dev,
                              None, edges), y)
        loss.backward()
        named = list(model.named_parameters())
        out[tag] = (float(loss), _full([(n, p.grad) for n, p in named],
                                       mesh) if tag == "tp" else
                    {n: p.grad.numpy().copy() for n, p in named})
    return out


def _runners(tmp, mode, mesh_kw):
    """Each runner under ``mesh_kw`` (tp, or dp x tp): its losses, scores
    and whether its checkpoint loads in one process with its moments."""
    graph = toy_graph()
    out = {}
    for runner in RUNNERS:
        cfg = run_cfg(runner, None, tmp).replace(
            task_name=f"{runner}_{mode}", n_epoch=1, **mesh_kw)
        res = _run(runner, cfg, graph)
        out[runner] = ([h["loss"] for h in res["history"]],
                       res.get("best_valid"))
    return out


def _resume_run(tmp, tag, **knobs):
    """``run_ogbn`` for 1 epoch, then resumed for a second; the whole
    state after it (rank 0's) as numpy: parameters, AdamW moments, step."""
    graph = toy_graph()
    cfg = run_cfg("ogbn", None, tmp).replace(task_name=f"resume_{tag}",
                                             n_epoch=1, **knobs)
    _run("ogbn", cfg, graph)
    res = engine.run_ogbn(cfg.replace(n_epoch=2), graph, max_eval_nodes=8,
                          log=lambda s: None, device="cpu", resume=True)
    state = res["state"]
    named = list(state.model.named_parameters())
    moments = {n: {k: v.numpy().copy() for k, v in st.items()
                   if torch.is_tensor(v) and v.dim()}
               for n, st in named_optimizer_state(state.optimizer,
                                                  named).items()}
    params = {n: p.detach().numpy().copy() for n, p in named}
    return params, moments, int(state.step), len(res["history"])


def _two_ranks(rank, world, p_np, tmp):
    mesh = pmesh.make_mesh(n_data=1, n_model=2)
    out = {"tp": _tp_step(p_np, mesh)}
    fl = _flagship(p_np)
    full_sd = {n: t.clone() for n, t in fl.model.state_dict().items()}
    back = pmesh.gather_params(pmesh.shard_model(fl.model, mesh), mesh)
    out["roundtrip"] = (None if back is None else
                        all(torch.equal(back[n], t)
                            for n, t in full_sd.items())
                        and set(back) == set(full_sd))
    out["axes"] = pmesh.param_shardings(fl.model)
    for name in PATHS:
        out[name] = _path_step(name, mesh)
    out["runners"] = _runners(tmp, "tp", dict(tp=2))
    out["resume_tp"] = _resume_run(tmp, "tp", tp=2)
    out["resume_pp"] = _resume_run(tmp, "pp", pp=2, pp_micro=1)
    return out


def _four_ranks(rank, world, p_np, tmp):
    mesh = pmesh.make_mesh(n_data=2, n_model=2)
    return {"dp_tp": _tp_step(p_np, mesh),
            "members": mesh.members(pmesh.MODEL_AXIS),
            "runners": _runners(tmp, "dp_tp", dict(dp=2, tp=2))}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's initial weights, their tree of ``param_shardings``
    on a 1 x 2 mesh, and per mode the mean loss, the mean gradients and
    the parameters after one update."""
    import jax
    import jax.numpy as jnp

    from pyhgt_tpu.flagship import build_flagship as jax_build
    from pyhgt_tpu.parallel.mesh import make_mesh, param_shardings
    from pyhgt_tpu.train import optim as joptim

    jf = jax_build("tiny", dropout=0.0)
    tf = build_flagship("tiny", device="cpu", **FLAGS)
    b0, _ = synth_flagship_batch(tf, 0)
    params = jax.jit(lambda key: jf.model.init(
        key, *jf.batch_args(b0), jf.em, se=jf.sort(b0)))(jax.random.key(0))
    vg = jax.jit(jax.value_and_grad(jf.loss_fn_single()))
    per = {}
    for seed in range(2):
        batch, labels = synth_flagship_batch(tf, seed)
        per[seed] = vg(params, jax.random.key(1), *jf.batch_args(batch),
                       jf.sort(batch), jnp.asarray(labels))
    tx = joptim.make_optimizer(joptim.cosine_schedule(1e-3, 1000),
                               weight_decay=0.01, clip_norm=0.25,
                               params=params)
    update = jax.jit(lambda g: jax.tree_util.tree_map(
        lambda p, u: p + u, params, tx.update(g, tx.init(params), params)[0]))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    refs = {}
    for mode, seeds in REFS.items():
        loss = float(np.mean([float(per[s][0]) for s in seeds]))
        grads = jax.tree_util.tree_map(
            lambda *g: sum(g) / len(g), *[per[s][1] for s in seeds])
        refs[mode] = (loss, flax_to_state_dict(to_np(grads)),
                      flax_to_state_dict(to_np(update(grads))))
    # each leaf's split axis over 'model' (-1: replicated), as a constant
    # array of the leaf's shape so convert maps it to the port's name
    mesh = make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    axes = jax.tree_util.tree_map(
        lambda p, sh: np.full(np.shape(p), float(
            list(sh.spec).index("model") if "model" in sh.spec else -1),
            np.float32),
        params, param_shardings(params, mesh))
    shard_axes = {n: int(t.reshape(-1)[0])
                  for n, t in flax_to_state_dict(axes).items()}
    return to_np(params), refs, shard_axes


@pytest.fixture(scope="module")
def worlds(jax_ref, tmp_path_factory):
    p_np = jax_ref[0]
    tmp = str(tmp_path_factory.mktemp("tp_runs"))
    return (spawn(_two_ranks, 2, p_np, tmp), spawn(_four_ranks, 4, p_np, tmp),
            tmp)


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("mode", ["tp", "dp_tp"])
def test_step_matches_jax(worlds, jax_ref, mode):
    two, four, _ = worlds
    ranks = [r[mode] for r in (two if mode == "tp" else four)]
    loss_ref, grads_ref, params_ref = jax_ref[1][mode]
    p_scale = max(float(v.abs().max()) for v in params_ref.values())
    for rank, (loss, grads, params, _) in enumerate(ranks):
        assert abs(loss - loss_ref) <= LOSS_TOL * abs(loss_ref), (
            mode, rank, loss, loss_ref)
        assert set(grads) == set(grads_ref) == set(params)
        for name, g in grads.items():
            _close(g, grads_ref[name].numpy(), GRAD_TOL,
                   f"{mode} rank {rank} grad {name}")
            err = float(np.abs(params[name] - params_ref[name].numpy()).max())
            assert err <= PARAM_TOL * p_scale, (mode, rank, name, err)
    # every model rank holds the same loss and replicated parameters
    for loss, _, _, rep in ranks[1:]:
        assert loss == ranks[0][0]
        assert set(rep) == set(ranks[0][3])
        for name, p in rep.items():
            np.testing.assert_array_equal(p, ranks[0][3][name])


def test_param_shardings_match_jax(worlds, jax_ref):
    two, four, _ = worlds
    want = {n: (None if a < 0 else a) for n, a in jax_ref[2].items()}
    assert two[0]["axes"] == want
    # the sharded leaves: the attention banks and the adapters, nothing else
    assert {n.rsplit(".", 1)[-1] for n, a in want.items() if a is not None} \
        == {"wq", "bq", "wk", "bk", "wv", "bv", "wa", "rel_pri", "rel_att",
            "rel_msg", "adapt_w", "adapt_b"}
    assert [r["members"] for r in four] == [[0, 1], [0, 1], [2, 3], [2, 3]]


def test_shard_then_gather_is_identity(worlds):
    two, _, _ = worlds
    assert two[0]["roundtrip"] is True and two[1]["roundtrip"] is None


@pytest.mark.parametrize("path", list(PATHS))
def test_alternate_path_under_tp_matches_one_process(worlds, path):
    two, _, _ = worlds
    for r in two:
        (loss1, g1), (loss2, g2) = r[path]["single"], r[path]["tp"]
        assert abs(loss2 - loss1) <= LOSS_TOL * abs(loss1), (path, loss1,
                                                             loss2)
        assert set(g1) == set(g2)
        for name in g1:
            _close(g2[name], g1[name], GRAD_TOL, f"{path} grad {name}")


@pytest.mark.parametrize("mode", ["tp", "dp_tp"])
def test_runners_train_under_tp(worlds, mode):
    two, four, tmp = worlds
    ranks = [r["runners"] for r in (two if mode == "tp" else four)]
    graph = toy_graph()
    for runner in RUNNERS:
        losses, best = ranks[0][runner]
        assert np.isfinite(losses).all() and best is not None, runner
        assert all(r[runner] == ranks[0][runner] for r in ranks), runner
        # rank 0's checkpoint is the whole model and optimizer
        cfg = run_cfg(runner, None, tmp)
        model = _single_model(runner, cfg, graph)
        state = load_checkpoint(
            f"{tmp}/{runner}_{mode}_hgt", TrainState(model, engine.make_tx(
                cfg, model.named_parameters(), 2)))
        assert state.step == 2 and len(state.optimizer.inner.state) == len(
            list(model.parameters())), runner


def _single_model(runner, cfg, graph):
    from test_torch_parallel_runs import _single_model as single

    return single(runner, cfg, graph)


@pytest.fixture(scope="module")
def single_resume(tmp_path_factory):
    return _resume_run(str(tmp_path_factory.mktemp("resume")), "single")


@pytest.mark.parametrize("mode", ["tp", "pp"])
def test_resume_restores_the_optimizer(worlds, single_resume, mode):
    two, _, _ = worlds
    params, moments, step, n_hist = two[0][f"resume_{mode}"]
    ref_params, ref_moments, ref_step, _ = single_resume
    assert (step, n_hist) == (ref_step, 1) and step == 4
    scale = max(float(np.abs(v).max()) for v in ref_params.values())
    assert set(params) == set(ref_params)
    for name, p in ref_params.items():
        err = float(np.abs(params[name] - p).max())
        assert err <= PARAM_TOL * scale, (mode, name, err)
    assert set(moments) == set(ref_moments) == set(ref_params)
    for name, st in ref_moments.items():
        assert set(moments[name]) == set(st) == {"exp_avg", "exp_avg_sq"}
        for k, v in st.items():
            _close(moments[name][k], v, PARAM_TOL, f"{mode} {k} {name}")
