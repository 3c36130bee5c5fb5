"""The port's forward against the JAX package's, with the same weights.

The JAX ``Flagship.init_params`` tree is carried into the port by
``pyhgt_tpu_torch.convert``; the same numpy batch goes through one
``hgt_conv_core_sorted`` layer and through the whole ``FlagshipModel`` of
both packages (flax ``apply`` is deterministic). The JAX side reaches its
Pallas kernel in interpret mode; the port's wrapper runs its plain version
on CPU tensors. Also here: the guards that keep JAX out of the port and
keep the port's entry points off the CPU unless asked.
"""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyhgt_tpu.flagship import build_flagship as jax_build
from pyhgt_tpu.ops.sorted_hgt import hgt_conv_core_sorted as jax_core
from pyhgt_tpu_torch.convert import flax_to_state_dict, load_flax_params
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.ops.pallas_seg import live_partials
from pyhgt_tpu_torch.ops.rte import rte_sin_table
from pyhgt_tpu_torch.ops.sorted_hgt import hgt_conv_core_sorted

ROOT = pathlib.Path(__file__).resolve().parent.parent

# flag sets over the tiny preset (n_hid 128, so the wide aggregation takes
# the kernel path). The tiny batch's tiles hold up to 129 target segments:
# rank cap 136 keeps the capped W = V aux, the bench preset's 64 falls back
# to the legacy W = K aux.
BENCH = dict(edge_bf16=True, seg_pallas=True, tab_cap=64,
             softmax_tilemax="on")
SETTINGS = {
    "f32-tiled": dict(seg_pallas=True, softmax_tilemax=""),
    "f32-tilemax": dict(seg_pallas=True, softmax_tilemax="on"),
    "bench-flags-cap136": dict(BENCH, seg_rank_cap=136),
    "bench-flags-cap64": dict(BENCH, seg_rank_cap=64),
}
# f32 settings: the two packages differ in summation order (f32 cumsums,
# the JAX kernel's bf16 hi/lo split at ~2^-16) — about 1e-4 on unit-scale
# values. bf16 settings: every per-edge tensor rounds to bf16 (2^-8
# relative), and XLA may fuse a chain of bf16 ops without the intermediate
# roundings torch makes, so single values can differ by a few bf16 ulps;
# 3e-2 on log-probs of magnitude ~3-6 bounds that.
TOL = {"f32-tiled": 1e-4, "f32-tilemax": 1e-4,
       "bench-flags-cap136": 3e-2, "bench-flags-cap64": 3e-2}


@pytest.fixture(scope="module")
def shared():
    """One JAX init (params are the same for every flag set) and one batch."""
    jf = jax_build("tiny")
    tf = build_flagship("tiny", device="cpu")
    batch, _ = synth_flagship_batch(tf, 0)
    se = jf.sort(batch)
    # Flagship.init_params under jit: the same tree, a few seconds sooner
    # than the eager trace
    params = jax.jit(lambda key: jf.model.init(
        key, *jf.batch_args(batch), jf.em, se=se))(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return batch, params, tree


def _pair(name):
    flags = SETTINGS[name]
    return jax_build("tiny", **flags), build_flagship("tiny", device="cpu",
                                                      **flags)


def test_convert_covers_every_parameter(shared):
    _, _, tree = shared
    tf = build_flagship("tiny", device="cpu")
    sd = flax_to_state_dict(tree)
    assert sd.keys() == tf.model.state_dict().keys()
    for k, v in tf.model.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_init_matches_jax_distributions(shared):
    """The port's seeded init draws from the JAX package's distributions
    (lecun_normal with flax's fan rule, glorot, zeros, ones)."""
    _, _, tree = shared
    ours = build_flagship("tiny", device="cpu", seed=1).model.state_dict()
    theirs = flax_to_state_dict(tree)
    for k, v in theirs.items():
        o = ours[k].numpy()
        v = v.numpy()
        if np.all(v == v.flat[0]):          # zeros / ones
            np.testing.assert_array_equal(o, v, k)
        else:                                # random: same scale and bound
            assert abs(o.std() / v.std() - 1) < 0.1, k
            assert np.abs(o).max() <= np.abs(v).max() * 1.1 + 1e-6, k
            assert abs(o.mean()) < 3 * v.std() / np.sqrt(v.size) + 1e-6, k


@pytest.mark.parametrize("name", list(SETTINGS))
def test_one_layer_matches_jax(shared, name):
    batch, _, tree = shared
    jf, tf = _pair(name)
    c = tf.cfg
    p = tree["params"]["gnn"]["convs_0"]["base_conv"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=batch.node_feat.shape[:2] + (c.n_hid,)).astype(
        np.float32)
    rte_vec = rte_sin_table(c.n_hid) @ p["rte_w"] + p["rte_b"]
    names = ("wq", "bq", "wk", "bk", "wv", "bv", "rel_pri", "rel_att",
             "rel_msg")
    jout = jax_core(
        jnp.asarray(x), jf.sort(batch), jf.em,
        **{n: jnp.asarray(p[n]) for n in names},
        n_heads=c.n_heads, rte_vec=jnp.asarray(rte_vec),
        edge_dtype=jnp.bfloat16 if c.edge_bf16 else None,
        seg_pallas=c.seg_pallas, softmax_tilemax=c.softmax_tilemax,
    )
    tout = hgt_conv_core_sorted(
        torch.from_numpy(x), tf.sort(batch).to("cpu"), tf.em.to("cpu"),
        **{n: torch.tensor(p[n]) for n in names},
        n_heads=c.n_heads, rte_vec=torch.tensor(rte_vec),
        edge_dtype=torch.bfloat16 if c.edge_bf16 else None,
        seg_pallas=c.seg_pallas, softmax_tilemax=c.softmax_tilemax,
    )
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               rtol=TOL[name], atol=TOL[name])


@pytest.mark.parametrize("name", list(SETTINGS))
def test_flagship_log_probs_match_jax(shared, name):
    batch, params, tree = shared
    jf, tf = _pair(name)
    load_flax_params(tf.model, tree)
    jl = np.asarray(jf.forward_fn()(params, *jf.batch_args(batch),
                                    jf.sort(batch)))
    before = live_partials.launches
    tl = tf.forward(batch).numpy()
    assert live_partials.launches == before  # the CPU forward never launches
    assert tl.shape == (tf.cfg.n_seed, tf.cfg.n_classes)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(np.logaddexp.reduce(tl, axis=-1), 0.0,
                               atol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=TOL[name], atol=TOL[name])


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_flagship("tiny")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _jax_package_paths(path):
    """String constants of ``path`` (docstrings aside) that name a path into
    the JAX package: ``pyhgt_tpu/...`` in a literal, or the bare package name
    handed to a call (``os.path.join``, ``Path``, ``open``) or to the ``/``
    of a path."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            docs.add(id(body[0].value))

    def bare(n):
        return isinstance(n, ast.Constant) and n.value == "pyhgt_tpu"

    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs
                and re.search(r"(^|[^\w])pyhgt_tpu[/\\]", node.value)):
            yield node.value
        elif isinstance(node, ast.Call) and any(map(bare, node.args)):
            yield ast.unparse(node)
        elif (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div)
              and (bare(node.left) or bare(node.right))):
            yield ast.unparse(node)


def test_port_imports_no_jax():
    """No module of the port, nor the smoke run, imports JAX or the JAX
    package, and no module of the port names a path into the JAX package
    (so no build of the port reads one of its files)."""
    files = sorted((ROOT / "pyhgt_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "pyhgt_tpu")
    bad = [
        (str(f.relative_to(ROOT)), m)
        for f in files for m in _imported_modules(f)
        if m.split(".")[0] in banned
    ]
    assert len(files) > 10 and not bad, bad
    paths = [(str(f.relative_to(ROOT)), s) for f in files[:-1]
             for s in _jax_package_paths(f)]
    assert not paths, paths
