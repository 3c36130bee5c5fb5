"""Graph convolution modules.

Counterpart of :mod:`pyhgt_tpu.models.conv`:

- :class:`HGTConv` (``pyHGT/conv.py:11-139``: per-meta-relation
  attention, RTE, gated residual, per-type norm) and
  :class:`DenseHGTConv` (``conv.py:143-280``: the same attention, a plain
  residual and a shared position-wise FFN), each on two edge paths:
  ``edge_impl="sorted"``, the scatter-free stage of
  :func:`pyhgt_tpu_torch.ops.sorted_hgt.hgt_conv_core_sorted` whose segment
  sums are the hand-written kernels, and ``"segment"``,
  :func:`pyhgt_tpu_torch.ops.hgt.hgt_conv_core` over the flat edge arrays;
- the baselines :class:`GCNConv`, :class:`GATConv`, :class:`RGCNConv`,
  :class:`HANConv` and :class:`HetGNNConv`, on the flat edge arrays and the
  segment primitives of :mod:`pyhgt_tpu_torch.ops.segment` (their per-edge
  gathers are ``index_select``, whose backward is an ``index_add_``; that
  module says why);
- :func:`general_conv`, the dispatcher by name (the JAX ``GeneralConv``).

Every conv's ``forward(x [T,C,Din], node_mask [T,C], se, em,
generator=None, edges=None, pe=None)`` reads the sorted layout ``se`` (a
:class:`~pyhgt_tpu_torch.sampling.sorted_batch.SortedEdges`) or the raw
edge arrays ``edges = (edge_src, edge_tgt, edge_dt, edge_mask)``, as its
path needs; ``pe``, this rank's
:class:`~pyhgt_tpu_torch.parallel.edge_partition.EdgeShard` of an
edge-partitioned batch, runs :class:`HGTConv` partitioned when it was built
with ``graph_axis`` (every other conv raises on it, as it cannot run
partitioned); ``em`` is an :class:`~pyhgt_tpu_torch.ops.hgt.EdgeStaticMeta`
on x's device. Parameters are stacked banks (``[T, ...]`` per node type,
``[R, ...]`` per relation) under the JAX package's names and shapes; a
flax ``Dense`` is a ``Linear`` under the flax name (``Dense_0``, ``mid``),
its kernel transposed (:mod:`pyhgt_tpu_torch.convert`).

Under tensor parallelism (:func:`pyhgt_tpu_torch.parallel.mesh.shard_model`)
an HGT conv holds its model rank's heads: ``wq/wk/wv [T, Din, D/tp]``,
``rel_* [R, H/tp, ...]``, ``wa [T, D/tp, D]``. Its input and the RTE
vectors enter the column-parallel projections through Megatron's "f"
(their gradients summed over the model group), the edge stage runs on
``H / tp`` heads, ``gelu`` stays head-local, and the row-parallel A
linear's partial sums meet in one all-reduce per conv before ``ba``. Every
tensor after that is replicated. The other convs match no sharding rule
and run replicated.

``remat`` (the JAX ``jax.checkpoint`` of the attention core) recomputes an
HGT conv's edge core in the backward instead of keeping its saved
tensors (:meth:`_HGTAttention._remat`). Under ``param_bf16``
(:func:`pyhgt_tpu_torch.train.optim.with_bf16_params`) the weight banks
arrive as bf16 tensors: every product with an activation runs in the
dtype ``torch.promote_types`` gives the pair (:func:`promoted`), as JAX
promotes, so an f32 activation meets the bank's rounded values in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pyhgt_tpu_torch.ops.hgt import hgt_conv_core, typed_linear
from pyhgt_tpu_torch.ops.rte import rte_sin_table
from pyhgt_tpu_torch.ops.segment import segment_softmax, segment_sum
from pyhgt_tpu_torch.ops.sorted_hgt import (
    hgt_conv_core_sorted,
    sum_grads_over,
    sum_over,
)
from pyhgt_tpu_torch.parallel.edge_partition import hgt_conv_core_partitioned
from pyhgt_tpu_torch.utils.counters import register

EDGE_IMPLS = ("segment", "sorted")
# the convs of general_conv, in the JAX package's order
CONV_NAMES = ("hgt", "dense_hgt", "gcn", "gat", "rgcn", "han", "hetgnn")

# DenseHGTConv's profiler ranges: the update half (A linear, dropout,
# residual, typed norm) and the position-wise FFN (through ``ffn_ln``)
UPDATE_SPAN, FFN_SPAN = "dense_hgt.update", "dense_hgt.ffn"


class _FFNCounts:
    """How often :class:`DenseHGTConv`'s FFN ran (``calls``, one a
    forward, each over the layout's ``T * C`` padded rows), counted on the
    host as the kernels' ``launches`` are; a CUDA graph's replay advances
    it by what its capture counted (:mod:`pyhgt_tpu_torch.utils.counters`)."""

    calls = 0


ffn_counts = register(_FFNCounts(), "calls")

# stddev of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal`` (truncated normal, variance 1/fan_in) with
    flax's fan rule: fan_in = shape[-2] times every leading dim, so a
    stacked ``[T, Din, Dout]`` bank draws with fan_in = T*Din exactly as the
    JAX package's does. Each leading slice is filled on its own."""
    fan_in = t.shape[-2] * math.prod(t.shape[:-2])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        for s in t.reshape(-1, *t.shape[-2:]):
            nn.init.trunc_normal_(s, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
    return t


def glorot_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """PyG-style glorot (the JAX package's ``glorot``): uniform(-a, a),
    a = sqrt(6 / (fan_in + fan_out)) over the last two dims
    (``pyHGT/conv.py:53-54``)."""
    a = (6.0 / (t.shape[-2] + t.shape[-1])) ** 0.5
    with torch.no_grad():
        return t.uniform_(-a, a, generator=generator)


def dropout(x, p: float, training: bool, generator=None):
    """Inverted dropout (flax ``nn.Dropout``: keep with probability 1 - p,
    scale the kept values by 1 / (1 - p)) whose mask is drawn from
    ``generator``, a ``torch.Generator`` on x's device, so a training step
    is reproducible from its seed; ``None`` draws from the global one."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


def promoted(x, *ws):
    """``x`` and the weights ``ws`` in the dtype ``torch.promote_types``
    gives them together (JAX's promotion of mixed operands): an f32
    activation and a bf16 bank (``param_bf16``) meet in f32, on the bank's
    rounded values; operands already of that dtype pass unchanged."""
    dt = x.dtype
    for w in ws:
        dt = torch.promote_types(dt, w.dtype)
    return (x.to(dt), *(w.to(dt) for w in ws))


class Dense(nn.Linear):
    """A ``Linear`` that computes as flax's ``Dense``: input, kernel and
    bias in the dtype they promote to together (:func:`promoted`)."""

    def forward(self, x):
        if self.bias is None:
            x, w = promoted(x, self.weight)
            return F.linear(x, w)
        x, w, b = promoted(x, self.weight, self.bias)
        return F.linear(x, w, b)


def dense(n_in, n_out, generator: torch.Generator,
          bias: bool = True) -> nn.Linear:
    """A ``Linear`` initialized as flax's ``Dense`` (lecun_normal kernel,
    zero bias)."""
    linear = Dense(n_in, n_out, bias=bias)
    with torch.no_grad():
        # flax kernel [in, out] = torch weight [out, in] transposed
        kernel = lecun_normal_(torch.empty(n_in, n_out), generator)
        linear.weight.copy_(kernel.T)
        if bias:
            linear.bias.zero_()
    return linear


def _param(generator, *shape, init):
    """A parameter of ``shape`` drawn by ``init``: "lecun", "glorot" or a
    constant."""
    t = torch.empty(shape)
    if init == "lecun":
        lecun_normal_(t, generator)
    elif init == "glorot":
        glorot_(t, generator)
    else:
        t.fill_(init)
    return nn.Parameter(t)


def _typed_layer_norm(x, scale, bias, eps=1e-5):
    """Per-type LayerNorm: x [T, C, D], scale/bias [T, D]; biased variance
    as in ``jnp.var``."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    xn = (x - mu) * torch.rsqrt(var + eps)
    return xn * scale[:, None, :] + bias[:, None, :]


class FlaxLayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last dim: epsilon 1e-6 and the fast
    variance E[x²] - E[x]² clipped at 0 (not ``torch.nn.LayerNorm``'s
    1e-5 and two-pass variance); parameters ``scale`` and ``bias`` as
    flax names them."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu,
                          min=0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


def _no_partition(pe, who: str):
    if pe is not None:
        raise ValueError(f"{who} cannot run edge-partitioned (gp > 1): "
                         "only the hgt conv can")


def _edge_arrays(edges, who: str):
    """``(src, tgt, dt, mask)`` as index tensors and a bool mask; a conv
    that reads the raw edge arrays raises when it is given none."""
    if edges is None:
        raise ValueError(f"{who} reads the raw edge arrays: pass "
                         "edges=(edge_src, edge_tgt, edge_dt, edge_mask)")
    src, tgt, dt, mask = edges
    return src.long(), tgt.long(), dt.long(), mask.bool()


class _HGTAttention(nn.Module):
    """The parameters and the edge stage that :class:`HGTConv` and
    :class:`DenseHGTConv` share (their message halves are the same in the
    reference): the Q/K/V/A banks, the relation banks, the per-type norm's
    parameters when ``typed_norm``, the skip gate when ``skip_gate``, and
    the RTE linear."""

    def __init__(self, in_dim, out_dim, num_types, num_relations, n_heads,
                 *, generator: torch.Generator, dropout, use_norm, use_rte,
                 edge_impl, save_kv, edge_bf16, seg_pallas, softmax_tilemax,
                 softmax_pallas, edge_bwd, skip_gate: bool,
                 typed_norm: bool, graph_axis: str = "",
                 gp_overlap: bool = False, remat: bool = False):
        super().__init__()
        T, R, H = num_types, num_relations, n_heads
        Din, Dout = in_dim, out_dim
        dk = Dout // H
        if dk * H != Dout:
            raise ValueError(f"out_dim {Dout} not divisible by n_heads {H}")
        if edge_impl not in EDGE_IMPLS:
            raise ValueError(f"edge_impl {edge_impl!r} not in {EDGE_IMPLS}")
        self.in_dim, self.n_heads = in_dim, n_heads
        self.use_norm, self.use_rte = use_norm, use_rte
        self.edge_impl = edge_impl
        self.edge_bf16, self.seg_pallas = edge_bf16, seg_pallas
        self.save_kv, self.dropout = save_kv, dropout
        # "" off | "on" unguarded | "auto" guarded per batch
        self.softmax_tilemax = softmax_tilemax
        self.softmax_pallas = softmax_pallas
        self.edge_bwd = edge_bwd  # permute | recompute | src_direct | slab
        # recompute the edge core in the backward (jax.checkpoint)
        self.remat = remat
        # "graph": run edge-partitioned when a forward is given an EdgeShard
        self.graph_axis, self.gp_overlap = graph_axis, gp_overlap
        # tensor parallelism: the model group this rank's heads belong to
        self.model_group, self.n_model = None, 1

        def p(*shape, init):
            return _param(generator, *shape, init=init)

        self.wq = p(T, Din, Dout, init="lecun")
        self.bq = p(T, Dout, init=0.0)
        self.wk = p(T, Din, Dout, init="lecun")
        self.bk = p(T, Dout, init=0.0)
        self.wv = p(T, Din, Dout, init="lecun")
        self.bv = p(T, Dout, init=0.0)
        self.wa = p(T, Dout, Dout, init="lecun")
        self.ba = p(T, Dout, init=0.0)
        # relation banks (conv.py:41-54); rel_pri init 1 (conv.py:44)
        self.rel_pri = p(R, H, init=1.0)
        self.rel_att = p(R, H, dk, dk, init="glorot")
        self.rel_msg = p(R, H, dk, dk, init="glorot")
        if skip_gate:
            # learnable per-type skip gate, init 1 (conv.py:47)
            self.skip = p(T, init=1.0)
        if typed_norm:
            self.ln_scale = p(T, Dout, init=1.0)
            self.ln_bias = p(T, Dout, init=0.0)
        if use_rte:
            # frozen sinusoidal table (conv.py:289-295) + trainable linear
            self.rte_w = p(Din, Din, init="lecun")
            self.rte_b = p(Din, init=0.0)
            self.register_buffer(
                "rte_table", torch.from_numpy(rte_sin_table(Din)),
                persistent=False,
            )

    def rte_vectors(self):
        """[L, Din] — sin table through the trainable RTE linear."""
        table, w = promoted(self.rte_table, self.rte_w)
        return table @ w + self.rte_b

    def bind_model_group(self, group, n_model: int):
        """Run on this rank's ``1 / n_model`` of the heads (the banks cut by
        :func:`~pyhgt_tpu_torch.parallel.mesh.shard_model`), with ``group``
        the model group."""
        if self.n_heads % n_model:
            raise ValueError(f"n_heads {self.n_heads} does not split over "
                             f"tp = {n_model}")
        if self.graph_axis:
            raise ValueError("tp does not compose with gp")
        self.model_group, self.n_model = group, n_model

    def _inputs(self, x):
        """``x`` and the banks the edge core reads. Under tp ``x`` and the
        RTE vectors pass through "f" together (one all-reduce of their
        gradients in the backward), and ``n_heads`` is this rank's. A bf16
        bank (``param_bf16``) is promoted here, once: the core reads
        ``wk``, ``wv`` and the relation banks twice each, and promoted at
        each read its gradient would round to bf16 per read and sum in
        bf16."""
        rte = self.rte_vectors() if self.use_rte else None
        if self.model_group is not None:
            x, *rest = sum_grads_over(self.model_group, x,
                                      *(() if rte is None else (rte,)))
            rte = rest[0] if rest else None
        _, wq, wk, wv, rel_att, rel_msg = promoted(
            x, self.wq, self.wk, self.wv, self.rel_att, self.rel_msg)
        return x, dict(wq=wq, bq=self.bq, wk=wk, bk=self.bk, wv=wv,
                       bv=self.bv, rel_pri=self.rel_pri, rel_att=rel_att,
                       rel_msg=rel_msg, n_heads=self.n_heads // self.n_model,
                       rte_vec=rte)

    def _project(self, a):
        """The per-type A linear ``a @ wa + ba``; under tp ``wa`` is
        row-parallel, so the partial sums are summed over the model group
        ("g") and ``ba`` is added once after the sum."""
        if self.model_group is None:
            return typed_linear(a, self.wa, self.ba)
        part = sum_over(typed_linear(a, self.wa), self.model_group)
        return part + self.ba.to(part.dtype)[:, None, :]

    def _remat(self, core, *args, **kwargs):
        """``core(*args, **kwargs)``, an edge core; under ``remat`` in a
        differentiated forward through ``torch.utils.checkpoint`` (non
        reentrant): its saved tensors (the edge Function's per-edge ones
        among them) are dropped and the core runs again in the backward,
        its kernels and its host reads (the ``"auto"`` softmax guard, and
        under gp the guard's and the statistics' exchanges) with it, in
        the same order on every rank. The core draws no random numbers
        (dropout is outside it), so no RNG state is stashed. The callers
        keep tp's "f" and "g" outside the core, so each of their
        collectives runs once."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(core, *args, use_reentrant=False,
                              preserve_rng_state=False, **kwargs)
        return core(*args, **kwargs)

    def _core(self, x, se, em, **kw):
        x, banks = self._inputs(x)
        return self._remat(
            hgt_conv_core_sorted, x, se, em, **banks,
            edge_dtype=torch.bfloat16 if self.edge_bf16 else None,
            seg_pallas=self.seg_pallas,
            softmax_pallas=self.softmax_pallas, **kw,
        )

    def _segment_core(self, x, edges, em):
        src, tgt, dt, mask = _edge_arrays(edges, "edge_impl='segment'")
        x, banks = self._inputs(x)
        return self._remat(hgt_conv_core, x, src, tgt, dt, mask, em, **banks)

    @torch.no_grad()
    def attention_weights(self, x, se, em, edges=None):
        """``[E, H]`` softmax attention per edge (the reference keeps it on
        the module for visualization, ``pyHGT/conv.py:106-108``), in the
        layout of this conv's edge path (under tp this rank's heads):
        ``se``'s sorted edge order, where
        it rides the production core with ``return_attention`` (as in the
        JAX package, the shift-scan or kernel softmax computes them,
        whatever ``softmax_tilemax`` says), or the flat order of
        ``edges``."""
        if self.edge_impl == "segment":
            return self._segment_core(x, edges, em)[1]
        return self._core(x, se, em, return_attention=True)[1]

    def _aggregate(self, x, se, em, edges, pe=None):
        """``aggr [T, C, Dout]`` of the edge path ``edge_impl``, or of this
        rank's shard ``pe`` combined over its graph group."""
        if pe is not None:
            if not self.graph_axis:
                raise ValueError("an EdgeShard needs a conv built with "
                                 "graph_axis (gp > 1)")
            x, banks = self._inputs(x)
            return self._remat(
                hgt_conv_core_partitioned, x, pe, em, **banks,
                overlap=self.gp_overlap,
                save_kv=self.save_kv,
                edge_dtype=torch.bfloat16 if self.edge_bf16 else None,
                edge_bwd=self.edge_bwd, seg_pallas=self.seg_pallas,
                softmax_pallas=self.softmax_pallas,
                softmax_tilemax=("auto" if self.softmax_tilemax == "auto"
                                 else bool(self.softmax_tilemax)))
        if self.edge_impl == "segment":
            return self._segment_core(x, edges, em)[0]
        if se is None:
            raise ValueError("edge_impl='sorted' requires a SortedEdges batch")
        return self._core(
            x, se, em, save_kv=self.save_kv,
            softmax_tilemax=self.softmax_tilemax, edge_bwd=self.edge_bwd)


class HGTConv(_HGTAttention):
    """Heterogeneous Graph Transformer layer (``pyHGT/conv.py:11-139``).

    ``edge_impl`` picks the edge path: ``"segment"`` (the JAX default) or
    ``"sorted"``. Parameters are initialized from ``generator`` with the
    JAX package's distributions. In training mode the update half drops
    out after its linear, with the mask drawn from the forward's
    ``generator``.
    """

    def __init__(self, in_dim, out_dim, num_types, num_relations, n_heads,
                 *, generator: torch.Generator, dropout=0.2, use_norm=True,
                 use_rte=True, edge_impl="segment", save_kv=False,
                 edge_bf16=False, seg_pallas=False, softmax_tilemax="",
                 softmax_pallas=False, edge_bwd="permute", graph_axis="",
                 gp_overlap=False, remat=False):
        super().__init__(
            in_dim, out_dim, num_types, num_relations, n_heads,
            generator=generator, dropout=dropout, use_norm=use_norm,
            use_rte=use_rte, edge_impl=edge_impl, save_kv=save_kv,
            edge_bf16=edge_bf16, seg_pallas=seg_pallas,
            softmax_tilemax=softmax_tilemax, softmax_pallas=softmax_pallas,
            edge_bwd=edge_bwd, skip_gate=True, typed_norm=use_norm,
            graph_axis=graph_axis, gp_overlap=gp_overlap, remat=remat)

    def forward(self, x, node_mask, se, em, generator=None, edges=None,
                pe=None):
        aggr = self._aggregate(x, se, em, edges, pe)
        # update half (conv.py:114-134): exact (erf) gelu as the reference's
        # F.gelu (conv.py:119), per-type A linear, sigmoid skip gate, norm
        trans = self._project(F.gelu(aggr))
        trans = dropout(trans, self.dropout, self.training, generator)
        alpha = torch.sigmoid(self.skip)[:, None, None]
        out = trans * alpha + x * (1.0 - alpha)
        if self.use_norm:
            out = _typed_layer_norm(out, self.ln_scale, self.ln_bias)
        return out * node_mask[..., None]


class DenseHGTConv(_HGTAttention):
    """HGT attention + plain residual + shared position-wise FFN
    (``pyHGT/conv.py:143-280``; the message half is HGTConv's, on either
    edge path). ``use_norm`` gates the per-type norm (whose parameters
    exist either way, as in the JAX package); the final norm over the
    FFN's output and its input (``ffn_ln``, a flax LayerNorm) is always
    on. A forward runs the update half and the FFN inside the profiler
    ranges :data:`UPDATE_SPAN` and :data:`FFN_SPAN` and advances
    :data:`ffn_counts`."""

    def __init__(self, in_dim, out_dim, num_types, num_relations, n_heads,
                 *, generator: torch.Generator, dropout=0.2, use_norm=True,
                 use_rte=True, edge_impl="segment", save_kv=False,
                 edge_bf16=False, seg_pallas=False, softmax_tilemax="",
                 softmax_pallas=False, edge_bwd="permute", remat=False):
        super().__init__(
            in_dim, out_dim, num_types, num_relations, n_heads,
            generator=generator, dropout=dropout, use_norm=use_norm,
            use_rte=use_rte, edge_impl=edge_impl, save_kv=save_kv,
            edge_bf16=edge_bf16, seg_pallas=seg_pallas,
            softmax_tilemax=softmax_tilemax, softmax_pallas=softmax_pallas,
            edge_bwd=edge_bwd, skip_gate=False, typed_norm=True,
            remat=remat)
        # shared position-wise FFN (conv.py:189-191) + final shared norm
        self.mid = dense(out_dim, out_dim * 2, generator)
        self.out = dense(out_dim * 2, out_dim, generator)
        self.ffn_ln = FlaxLayerNorm(out_dim)

    def forward(self, x, node_mask, se, em, generator=None, edges=None,
                pe=None):
        # the JAX DenseHGTConv has no partitioned path either
        _no_partition(pe, "DenseHGTConv")
        aggr = self._aggregate(x, se, em, edges)
        with torch.profiler.record_function(UPDATE_SPAN):
            trans = self._project(aggr)
            trans = dropout(trans, self.dropout, self.training, generator)
            res = trans + x
            if self.use_norm:  # per-type norm gated (conv.py:265-266)
                res = _typed_layer_norm(res, self.ln_scale, self.ln_bias)
        with torch.profiler.record_function(FFN_SPAN):
            ffn = self.out(F.gelu(self.mid(res)))
            ffn = dropout(ffn, self.dropout, self.training, generator)
            out = self.ffn_ln(ffn + res)
        ffn_counts.calls += 1
        return out * node_mask[..., None]


class GCNConv(nn.Module):
    """Homogeneous GCN baseline (the reference routes to PyG's
    ``GCNConv``, ``conv.py:311-312``): a symmetric-degree-normalized sum
    over all edges, types and times ignored. Self-loops are the layout's
    'self' blocks."""

    def __init__(self, in_dim, out_dim, *, generator: torch.Generator):
        super().__init__()
        self.out_dim = out_dim
        self.Dense_0 = dense(in_dim, out_dim, generator)

    def forward(self, x, node_mask, se, em, generator=None, edges=None,
                pe=None):
        _no_partition(pe, "GCNConv")
        src, tgt, _, mask = _edge_arrays(edges, "GCNConv")
        T, C, _ = x.shape
        N = T * C
        h = self.Dense_0(x).reshape(N, self.out_dim)
        ones = mask.to(h.dtype)
        deg = segment_sum(ones, tgt, N)
        inv_sqrt = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                               torch.zeros_like(deg))
        coef = (inv_sqrt.index_select(0, tgt) * inv_sqrt.index_select(0, src)
                * ones)
        out = segment_sum(h.index_select(0, src) * coef[:, None], tgt, N)
        return out.reshape(T, C, self.out_dim) * node_mask[..., None]


class GATConv(nn.Module):
    """Homogeneous multi-head GAT baseline (the reference routes to PyG's
    ``GATConv``, ``conv.py:313-314``): additive attention with LeakyReLU,
    softmax over incoming edges. ``dropout`` is kept as a field, as in the
    JAX package, whose body never reads it: there is no attention
    dropout."""

    def __init__(self, in_dim, out_dim, n_heads=1, negative_slope=0.2,
                 dropout=0.2, *, generator: torch.Generator):
        super().__init__()
        self.out_dim, self.n_heads = out_dim, n_heads
        self.negative_slope, self.dropout = negative_slope, dropout
        dk = out_dim // n_heads
        self.Dense_0 = dense(in_dim, out_dim, generator, bias=False)
        self.a_src = _param(generator, n_heads, dk, init="lecun")
        self.a_tgt = _param(generator, n_heads, dk, init="lecun")

    def forward(self, x, node_mask, se, em, generator=None, edges=None,
                pe=None):
        _no_partition(pe, "GATConv")
        src, tgt, _, mask = _edge_arrays(edges, "GATConv")
        T, C, _ = x.shape
        H = self.n_heads
        N = T * C
        h = self.Dense_0(x).reshape(N, H, self.out_dim // H)
        h_src = h.index_select(0, src)
        e = ((h_src * self.a_src).sum(-1)
             + (h.index_select(0, tgt) * self.a_tgt).sum(-1))
        e = F.leaky_relu(e, negative_slope=self.negative_slope)
        w = segment_softmax(e, tgt, N, mask=mask)
        out = segment_sum((w[..., None] * h_src).reshape(-1, self.out_dim),
                          tgt, N, mask=mask)
        return out.reshape(T, C, self.out_dim) * node_mask[..., None]


class RGCNConv(nn.Module):
    """Relational GCN (Schlichtkrull et al. 2018), which the reference CLI
    advertises but never implements (``OAG/train_paper_field.py:28``):
    one matrix per relation and an in-degree mean over all incoming edges,
    ``out_i = relu((sum_{e: j->i} W_{r(e)} x_j) / deg_i + b)``. The
    relation transform runs at node level per edge block, as HGT's does,
    so the per-edge work is a gather and a normalized segment sum."""

    def __init__(self, in_dim, out_dim, num_relations, *,
                 generator: torch.Generator):
        super().__init__()
        self.out_dim = out_dim
        self.w_rel = _param(generator, num_relations, in_dim, out_dim,
                            init="lecun")
        self.b = _param(generator, out_dim, init=0.0)

    def forward(self, x, node_mask, se, em, generator=None, edges=None,
                pe=None):
        _no_partition(pe, "RGCNConv")
        src, tgt, _, mask = _edge_arrays(edges, "RGCNConv")
        T, C, Din = x.shape
        N = T * C
        B = em.block_src.shape[0]
        rows = em.block_src[:, None] * C + torch.arange(C, device=x.device)
        by_block = x.reshape(N, Din).index_select(
            0, rows.reshape(-1)).reshape(B, C, Din)
        # the bank in f32 before the gather (its gradient sums in f32)
        mats = self.w_rel.float().index_select(0, em.block_rel)
        h_rel = torch.einsum("bcd,bde->bce", by_block.float(),
                             mats).reshape(-1, self.out_dim)
        # a masked edge's offset may go below 0: wrapped, as in hgt_conv_core
        h_e = h_rel.index_select(0, torch.remainder(src + em.gather_off,
                                                    B * C))
        ones = mask.to(h_e.dtype)
        deg = segment_sum(ones, tgt, N)
        inv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1e-12),
                          torch.zeros_like(deg))
        out = segment_sum(h_e * ones[:, None], tgt, N) * inv[:, None]
        out = torch.relu(out + self.b)
        return out.reshape(T, C, self.out_dim) * node_mask[..., None]


class HANConv(nn.Module):
    """HAN-style layer (Wang et al. 2019), which the reference CLI
    advertises but never implements: node-level GAT attention within each
    relation (the segment key ``edge_tgt * R + rel`` keeps the softmax
    inside a relation), then semantic attention over the relations with
    weights ``beta_r = softmax_r(mean_n q . tanh(W h_r[n] + b))``, the mean
    over every valid node of the batch (``node_mask``)."""

    def __init__(self, in_dim, out_dim, num_relations, n_heads=4,
                 negative_slope=0.2, sem_dim=128, *,
                 generator: torch.Generator):
        super().__init__()
        self.out_dim, self.n_heads = out_dim, n_heads
        self.num_relations = num_relations
        self.negative_slope = negative_slope
        dk = out_dim // n_heads
        R = num_relations
        self.Dense_0 = dense(in_dim, out_dim, generator, bias=False)
        self.a_src = _param(generator, R, n_heads, dk, init="lecun")
        self.a_tgt = _param(generator, R, n_heads, dk, init="lecun")
        self.Dense_1 = dense(out_dim, sem_dim, generator)
        self.sem_q = _param(generator, sem_dim, 1, init="lecun")

    def forward(self, x, node_mask, se, em, generator=None, edges=None,
                pe=None):
        _no_partition(pe, "HANConv")
        src, tgt, _, mask = _edge_arrays(edges, "HANConv")
        T, C, _ = x.shape
        H, R, D = self.n_heads, self.num_relations, self.out_dim
        N = T * C
        h = self.Dense_0(x).reshape(N, H, D // H)
        rel = em.edge_rel
        h_src = h.index_select(0, src)
        # the banks promoted before their per-edge gathers (their
        # gradients then sum over the edges in the promoted dtype)
        _, a_src, a_tgt = promoted(h, self.a_src, self.a_tgt)
        e = ((h_src * a_src.index_select(0, rel)).sum(-1)
             + (h.index_select(0, tgt) * a_tgt.index_select(0, rel)).sum(-1))
        e = F.leaky_relu(e, negative_slope=self.negative_slope)
        seg = tgt * R + rel
        w = segment_softmax(e, seg, N * R, mask=mask)
        msg = (w[:, :, None] * h_src).reshape(-1, D)
        h_rel = segment_sum(msg, seg, N * R, mask=mask).reshape(N, R, D)
        # semantic attention over relations (weights over the whole batch)
        proj = torch.tanh(self.Dense_1(h_rel))
        nm = node_mask.reshape(N, 1, 1).to(proj.dtype)
        scores = (torch.matmul(*promoted(proj, self.sem_q)) * nm).sum(dim=0) \
            / torch.clamp(nm.sum(), min=1.0)
        beta = torch.softmax(scores.reshape(R), dim=0)
        out = torch.einsum("nrd,r->nd", h_rel, beta)
        return out.reshape(T, C, D) * node_mask[..., None]


class HetGNNConv(nn.Module):
    """HetGNN-style layer (Zhang et al. 2019), which the reference CLI
    advertises but never implements: neighbours averaged per source type
    (a content mean in place of the paper's BiLSTM), then type-level
    attention over the per-type means and the node's own transform."""

    def __init__(self, in_dim, out_dim, num_types, *,
                 generator: torch.Generator):
        super().__init__()
        self.out_dim, self.num_types = out_dim, num_types
        self.Dense_0 = dense(in_dim, out_dim, generator)
        self.a = _param(generator, out_dim, 1, init="lecun")

    def forward(self, x, node_mask, se, em, generator=None, edges=None,
                pe=None):
        _no_partition(pe, "HetGNNConv")
        src, tgt, _, mask = _edge_arrays(edges, "HetGNNConv")
        T, C, _ = x.shape
        N, D = T * C, self.out_dim
        h = self.Dense_0(x).reshape(N, D)
        # mean per source type (segment key = tgt * T + src_type)
        seg = tgt * T + em.block_src.index_select(0, em.edge_block)
        ones = mask.to(h.dtype)
        cnt = segment_sum(ones, seg, N * T)
        agg = segment_sum(h.index_select(0, src) * ones[:, None], seg, N * T)
        agg = (agg / torch.clamp(cnt, min=1.0)[:, None]).reshape(N, T, D)
        # type-level attention, the self embedding included
        cand = torch.cat([h[:, None, :], agg], dim=1)     # [N, T+1, D]
        scores = F.leaky_relu(torch.matmul(*promoted(cand * h[:, None, :],
                                                     self.a)),
                              negative_slope=0.2)
        alpha = torch.softmax(scores, dim=1)              # [N, T+1, 1]
        out = (alpha * cand).sum(dim=1)
        return out.reshape(T, C, D) * node_mask[..., None]


def general_conv(conv_name, in_dim, out_dim, num_types, num_relations,
                 n_heads, *, generator: torch.Generator, dropout=0.2,
                 use_norm=True, use_rte=True, edge_impl="segment",
                 save_kv=False, edge_bf16=False, seg_pallas=False,
                 softmax_tilemax="", softmax_pallas=False,
                 edge_bwd="permute", graph_axis="",
                 gp_overlap=False, remat=False) -> nn.Module:
    """The conv named ``conv_name`` (the JAX ``GeneralConv`` dispatcher,
    ``pyHGT/conv.py:303-324``): one call signature for the heterogeneous
    (hgt, dense_hgt, rgcn, han, hetgnn) and homogeneous (gcn, gat) convs.
    The module is returned itself, not wrapped, so its parameters sit
    directly under ``convs.<i>``. ``graph_axis`` / ``gp_overlap`` reach
    :class:`HGTConv` (its edge-partitioned path); ``remat`` reaches the
    two HGT convs, whose edge core it recomputes in the backward (the JAX
    package's baselines take no ``remat`` either)."""
    kw = dict(in_dim=in_dim, out_dim=out_dim, generator=generator)
    hgt = dict(
        kw, num_types=num_types, num_relations=num_relations,
        n_heads=n_heads, dropout=dropout, use_norm=use_norm, use_rte=use_rte,
        edge_impl=edge_impl, save_kv=save_kv, edge_bf16=edge_bf16,
        seg_pallas=seg_pallas, softmax_tilemax=softmax_tilemax,
        softmax_pallas=softmax_pallas, edge_bwd=edge_bwd, remat=remat)
    if conv_name == "hgt":
        return HGTConv(**hgt, graph_axis=graph_axis, gp_overlap=gp_overlap)
    if conv_name == "dense_hgt":
        return DenseHGTConv(**hgt)
    if conv_name == "gcn":
        return GCNConv(**kw)
    if conv_name == "gat":
        return GATConv(**kw, n_heads=n_heads, dropout=dropout)
    if conv_name == "rgcn":
        return RGCNConv(**kw, num_relations=num_relations)
    if conv_name == "han":
        return HANConv(**kw, num_relations=num_relations, n_heads=n_heads)
    if conv_name == "hetgnn":
        return HetGNNConv(**kw, num_types=num_types)
    raise NotImplementedError(
        f"conv_name {conv_name!r} not supported; available: "
        "hgt, dense_hgt, gcn, gat, rgcn, han, hetgnn (the reference "
        "advertises rgcn/han/hetgnn without implementing any)"
    )
