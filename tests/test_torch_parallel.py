"""The port's parallel train steps against the JAX package's single-device
step, as the JAX package's own tests hold its modes
(``tests/test_parallel.py``, ``tests/test_edge_partition.py``).

The tiny flagship with the JAX package's initial weights (carried by
``convert``), dropout 0; the batches of seeds 0-3. The reference of each
mode is the JAX package's ``loss_fn_single`` and one update of the bench's
optimizer (AdamW, global-norm clip 0.25, weight decay 0.01,
``cosine_schedule(1e-3, 1000)``) on the mean loss of the batches the mode
trains on: gp = 2 on seed 0 (one batch's edges over two ranks), dp = 2 on
seeds 0 and 1, pp = 2 on seeds 0 and 1 (``pp_micro`` 2) and 0-3 (4), and
on four ranks dp x gp on seeds 0 and 1 and dp x pp on seeds 0-3. The loss
within 1e-5 of its value, every gradient within 1e-4 of its tensor's scale
(max |g|), every updated parameter within 1e-4 of the parameters' scale
(max |p| over the model: AdamW's first move, lr * g / (|g| + eps), turns
the f32 differences of a gradient near eps into differences of up to lr
in a leaf that starts at zero, as ``tests/test_torch_train_step.py``
sets out); every rank
holds the same loss, gradients and parameters (a pipeline stage: its own
layers and the shared ones). Each world is spawned once (gloo on the CPU).
Also: ``distributed.initialize`` in one process and in two, its refusal
of nccl with more ranks than cards, the mesh's rank layout, the pipeline
stacking round trip against the JAX package's tree, ``check_ported`` (tp
runs, tp with gp or pp refused with the JAX package's reasons,
``param_bf16``, ``remat`` and ``fused_opt`` accepted) and the pipeline's
preconditions, and the bench's gp mode.
"""

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch import bench
from pyhgt_tpu_torch.config import ExperimentConfig
from pyhgt_tpu_torch.convert import flax_to_state_dict, load_flax_params
from pyhgt_tpu_torch.experiments import engine
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.ops import sorted_hgt
from pyhgt_tpu_torch.parallel import distributed
from pyhgt_tpu_torch.parallel import mesh as pmesh
from pyhgt_tpu_torch.parallel import pipeline as ppl
from pyhgt_tpu_torch.parallel.distributed import spawn
from pyhgt_tpu_torch.parallel.spmd import dp_value_and_grad

LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-4
FLAGS = dict(dropout=0.0, seg_pallas=True)
# mode -> the batch seeds whose mean loss the step trains on
REFS = {"gp": (0,), "dp": (0, 1), "pp2": (0, 1), "pp4": (0, 1, 2, 3),
        "dp_gp": (0, 1), "dp_pp": (0, 1, 2, 3)}


def _flagship(p_np, **kw):
    fl = build_flagship("tiny", device="cpu", **FLAGS, **kw)
    load_flax_params(fl.model, p_np)
    return fl


def _device_args(fl, seed, se=None):
    batch, labels = synth_flagship_batch(fl, seed)
    return fl.to_device(batch, fl.sort(batch) if se is None else se(batch),
                        labels)


def _result(loss, named, optimizer):
    """(loss, gradients, parameters after the update) of the named
    parameters a rank trains."""
    grads = {n: p.grad.detach().numpy().copy() for n, p in named}
    optimizer.step()
    return (float(loss.detach()), grads,
            {n: p.detach().numpy().copy() for n, p in named})


def _gp_step(p_np, mesh):
    fl = _flagship(p_np, graph_axis="graph")
    d = mesh.index(pmesh.DATA_AXIS)
    opt = bench._optimizer(fl.model.named_parameters())
    g = mesh.group(pmesh.GRAPH_AXIS)
    shard = lambda b: fl.partition(fl.sort(b), mesh.size(
        pmesh.GRAPH_AXIS)).local(mesh.index(pmesh.GRAPH_AXIS), g)
    args = _device_args(fl, d, shard)
    loss = dp_value_and_grad(fl.loss, opt.params, mesh)(*args)
    return _result(loss, list(fl.model.named_parameters()), opt)


def _dp_step(p_np, mesh):
    fl = _flagship(p_np)
    opt = bench._optimizer(fl.model.named_parameters())
    args = _device_args(fl, mesh.index(pmesh.DATA_AXIS))
    loss = dp_value_and_grad(fl.loss, opt.params, mesh)(*args)
    return _result(loss, list(fl.model.named_parameters()), opt)


def _pp_step(p_np, mesh, n_micro):
    fl = _flagship(p_np)
    d = mesh.index(pmesh.DATA_AXIS)
    micro = []
    for seed in range(d * n_micro, (d + 1) * n_micro):
        b, se, y = _device_args(fl, seed)
        micro.append((b.node_feat, b.node_mask, se, None, y))
    loss_fn = ppl.make_pp_loss(fl, mesh, n_micro)
    named = loss_fn.stage.named_parameters()
    opt = bench._optimizer(named)
    vg = ppl.make_pp_value_and_grad(loss_fn, opt, mesh)
    loss = vg(fl.dropout_gen, micro)
    return _result(loss, named, opt)


def _two_ranks(rank, world, p_np):
    info = distributed.initialize("gloo", "cpu", world_size=world, rank=rank)
    x = pmesh.all_reduce(torch.tensor([float(rank + 1)]), None)
    summed = pmesh.all_reduce(torch.tensor([float(rank + 1)]),
                              torch.distributed.group.WORLD)
    world_g = torch.distributed.group.WORLD
    sent = pmesh.broadcast(torch.full((3,), float(rank)), 1, world_g)
    gathered = pmesh.all_gather(torch.tensor([rank, 10 * rank]), world_g)
    got = pmesh.exchange(torch.tensor([float(rank)]), 1 - rank, 1 - rank,
                         world_g)
    out = {"info": {k: v for k, v in info.items() if k != "device"},
           "sum": float(summed[0]), "alone": float(x[0]),
           "broadcast": sent.tolist(),
           "all_gather": [t.tolist() for t in gathered],
           "exchange": float(got[0])}
    out["gp"] = _gp_step(p_np, pmesh.make_mesh(n_data=1, n_graph=2))
    out["dp"] = _dp_step(p_np, pmesh.make_mesh(n_data=2))
    out["pp2"] = _pp_step(p_np, ppl.make_pipe_mesh(2), 2)
    out["pp4"] = _pp_step(p_np, ppl.make_pipe_mesh(2), 4)
    out["bench"] = bench.run_parallel("gp", 2, preset="tiny", steps=1,
                                      warmup=0, device="cpu", dropout=0.0)
    return out


def _four_ranks(rank, world, p_np):
    m = pmesh.make_mesh(n_data=2, n_graph=2)
    out = {"coords": m.coords, "graph": m.members(pmesh.GRAPH_AXIS),
           "data": m.members(pmesh.DATA_AXIS)}
    xr = torch.cos(torch.arange(21, dtype=torch.float32).reshape(7, 3)
                   * (rank + 1))
    world_g = torch.distributed.group.WORLD
    out["ring"] = {op: (sorted_hgt.ring_allreduce(xr, world_g, op).numpy(),
                        pmesh.all_reduce(xr.clone(), world_g, op).numpy())
                   for op in ("sum", "max")}
    out["dp_gp"] = _gp_step(p_np, m)
    out["dp_pp"] = _pp_step(p_np, ppl.make_pipe_mesh(2, n_data=2), 2)
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's initial weights and, per mode, the mean loss, the
    mean gradients and the parameters after one update."""
    import jax
    import jax.numpy as jnp

    from pyhgt_tpu.flagship import build_flagship as jax_build
    from pyhgt_tpu.train import optim as joptim

    jf = jax_build("tiny", dropout=0.0)
    tf = build_flagship("tiny", device="cpu", **FLAGS)
    b0, _ = synth_flagship_batch(tf, 0)
    params = jax.jit(lambda key: jf.model.init(
        key, *jf.batch_args(b0), jf.em, se=jf.sort(b0)))(jax.random.key(0))
    vg = jax.jit(jax.value_and_grad(jf.loss_fn_single()))
    per = {}
    for seed in range(4):
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
    return to_np(params), refs


@pytest.fixture(scope="module")
def worlds(jax_ref):
    p_np, _ = jax_ref
    return spawn(_two_ranks, 2, p_np), spawn(_four_ranks, 4, p_np)


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _check_mode(mode, ranks, ref, pipelined):
    loss_ref, grads_ref, params_ref = ref
    p_scale = max(float(v.abs().max()) for v in params_ref.values())
    seen = set()
    for rank, (loss, grads, params) in enumerate(ranks):
        assert abs(loss - loss_ref) <= LOSS_TOL * abs(loss_ref), (
            mode, rank, loss, loss_ref)
        for name, g in grads.items():
            _close(torch.as_tensor(g), grads_ref[name], GRAD_TOL,
                   f"{mode} rank {rank} grad {name}")
            err = float((torch.as_tensor(params[name])
                         - params_ref[name]).abs().max())
            assert err <= PARAM_TOL * p_scale, (mode, rank, name, err)
        seen |= set(grads)
    assert seen == set(grads_ref), mode    # every parameter, somewhere
    # the same loss, and the same gradients and parameters wherever two
    # ranks train the same one
    first = {}
    for loss, grads, params in ranks:
        assert loss == ranks[0][0], mode
        for name in grads:
            if name in first:
                np.testing.assert_array_equal(grads[name], first[name][0])
                np.testing.assert_array_equal(params[name], first[name][1])
            else:
                first[name] = (grads[name], params[name])
    if pipelined:
        # a stage trains its own layers and the shared parameters only
        per_rank = [set(g) for _, g, _ in ranks]
        assert all(n in s for s in per_rank for n in grads_ref
                   if not n.startswith("gnn.convs."))
        assert len(set.intersection(*per_rank)) < len(grads_ref)


@pytest.mark.parametrize("mode", ["gp", "dp", "pp2", "pp4"])
def test_two_rank_step_matches_jax(worlds, jax_ref, mode):
    two, _ = worlds
    _check_mode(mode, [r[mode] for r in two], jax_ref[1][mode],
                mode.startswith("pp"))


@pytest.mark.parametrize("mode", ["dp_gp", "dp_pp"])
def test_four_rank_step_matches_jax(worlds, jax_ref, mode):
    _, four = worlds
    _check_mode(mode, [r[mode] for r in four], jax_ref[1][mode],
                mode == "dp_pp")


def test_initialize_and_collectives(worlds):
    two, _ = worlds
    for rank, r in enumerate(two):
        assert r["info"] == {"process_index": rank, "process_count": 2,
                             "local_devices": 1, "global_devices": 2,
                             "backend": "gloo"}
        assert r["sum"] == 3.0 and r["alone"] == rank + 1
        assert r["broadcast"] == [1.0, 1.0, 1.0]
        assert r["all_gather"] == [[0, 0], [1, 10]]
        assert r["exchange"] == 1 - rank
    # one process: nothing starts
    info = distributed.initialize(device="cpu")
    assert (info["process_count"], info["backend"]) == (1, None)
    assert not torch.distributed.is_initialized()


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--dist_backend gloo"):
        distributed.check_backend("nccl", torch.device("cuda", 0), 2)
    distributed.check_backend("nccl", torch.device("cuda", 0), 1)
    distributed.check_backend("gloo", torch.device("cuda", 0), 2)
    with pytest.raises(ValueError, match="needs CUDA"):
        distributed.check_backend("nccl", torch.device("cpu"), 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="nccl cannot put 2 ranks"):
        distributed.initialize("nccl", world_size=2, rank=0)


def test_mesh_layout_and_ring(worlds):
    _, four = worlds
    for rank, r in enumerate(four):
        d, g = divmod(rank, 2)
        assert r["coords"] == {"data": d, "model": 0, "graph": g}
        assert r["graph"] == [2 * d, 2 * d + 1]
        assert r["data"] == [g, g + 2]
        for op in ("sum", "max"):
            got, ref = r["ring"][op]
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_pipeline_stack_roundtrip_matches_jax(jax_ref):
    from pyhgt_tpu.parallel.pipeline import stack_pipeline_params as jstack

    p_np, _ = jax_ref
    fl = _flagship(p_np)
    named = dict(fl.model.state_dict())
    pp = ppl.stack_pipeline_params(named, 2, 2)
    jpp = jstack(p_np, 2, 2)
    conv = jpp["stages"]["base_conv"]
    assert set(pp["stages"]) == {
        k if not isinstance(v, dict) else f"{k}.{s}"
        for k, v in conv.items() for s in ((v if isinstance(v, dict)
                                            else [None]))} - {None}
    for leaf, t in pp["stages"].items():
        assert t.shape[:2] == (2, 1), leaf
        np.testing.assert_array_equal(t.numpy(), np.asarray(conv[leaf]))
    shared = flax_to_state_dict({"gnn": {k: jpp["shared"][k] for k in
                                         ("adapt_w", "adapt_b")},
                                 "clf": jpp["shared"]["clf"]})
    assert set(pp["shared"]) == set(shared)
    for k, v in shared.items():
        np.testing.assert_array_equal(pp["shared"][k].numpy(), v.numpy())
    back = ppl.unstack_pipeline_params(pp, 2)
    assert set(back) == set(named)
    for k, v in named.items():
        assert torch.equal(back[k], v), k
    fl.model.load_state_dict(back, strict=True)


def test_bench_gp_mode_runs(worlds):
    two, _ = worlds
    rec = two[0]["bench"]
    assert rec["metric"] == "hgt_train_edges_per_s_gp2_cpu"
    assert np.isfinite(rec["value"]) and rec["value"] > 0


def test_check_ported_and_pipeline_preconditions():
    cfg = ExperimentConfig()
    for knob in ("dp", "tp", "gp", "pp"):
        engine.check_ported(cfg.replace(**{knob: 2}))
    engine.check_ported(cfg.replace(dp=2, tp=2))
    # the JAX package's refusals (pyhgt_tpu/experiments/engine.py)
    with pytest.raises(ValueError, match="gp>1 does not compose with tp>1"):
        engine.check_ported(cfg.replace(tp=2, gp=2))
    with pytest.raises(ValueError, match="pp composes with dp only"):
        engine.check_ported(cfg.replace(tp=2, pp=2))
    # the training-step extras run in every mode the JAX package allows
    for knobs in (dict(param_bf16=True), dict(remat=True),
                  dict(fused_opt=True, param_bf16=True, remat=True, dp=2,
                       tp=2), dict(param_bf16=True, remat=True, pp=2)):
        engine.check_ported(cfg.replace(**knobs))
    with pytest.raises(ValueError, match="n_layers=3 % pp=2"):
        ppl.check_pipeline(3, 2, True, True)
    with pytest.raises(ValueError, match="homogeneous"):
        ppl.check_pipeline(4, 2, True, False)
    with pytest.raises(ValueError, match="composes with dp only"):
        ppl.check_pipeline(4, 2, True, True, gp=2)
    assert pmesh.param_shardings({}, None) == {}
