"""The HGT convolution layer on the sorted-edge path.

Counterpart of :class:`pyhgt_tpu.models.conv.HGTConv` (``pyHGT/conv.py:
11-139``: per-meta-relation attention, RTE, gated residual, per-type
norm). Parameters are stacked banks (``[T, ...]`` per node type, ``[R, ...]``
per relation) under the JAX package's names and shapes, so a flax tree
loads with no transposes (:mod:`pyhgt_tpu_torch.convert`). The per-edge
stage is :func:`pyhgt_tpu_torch.ops.sorted_hgt.hgt_conv_core_sorted`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pyhgt_tpu_torch.ops.hgt import typed_linear
from pyhgt_tpu_torch.ops.rte import rte_sin_table
from pyhgt_tpu_torch.ops.sorted_hgt import hgt_conv_core_sorted

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


def _typed_layer_norm(x, scale, bias, eps=1e-5):
    """Per-type LayerNorm: x [T, C, D], scale/bias [T, D]; biased variance
    as in ``jnp.var``."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    xn = (x - mu) * torch.rsqrt(var + eps)
    return xn * scale[:, None, :] + bias[:, None, :]


class HGTConv(nn.Module):
    """Heterogeneous Graph Transformer layer on the sorted-edge path.

    ``forward(x [T,C,Din], node_mask [T,C], se, em)``: ``se`` is a
    :class:`~pyhgt_tpu_torch.sampling.sorted_batch.SortedEdges` and ``em``
    an :class:`~pyhgt_tpu_torch.ops.hgt.EdgeStaticMeta`, both on x's
    device. Parameters are initialized from ``generator`` with the JAX
    package's distributions. In training mode the update half drops out
    after its linear, with the mask drawn from the forward's ``generator``.
    """

    def __init__(self, in_dim, out_dim, num_types, num_relations, n_heads,
                 *, generator: torch.Generator, dropout=0.2, use_norm=True,
                 use_rte=True, save_kv=False, edge_bf16=False,
                 seg_pallas=False, softmax_tilemax="", softmax_pallas=False,
                 edge_bwd="permute"):
        super().__init__()
        T, R, H = num_types, num_relations, n_heads
        Din, Dout = in_dim, out_dim
        dk = Dout // H
        if dk * H != Dout:
            raise ValueError(f"out_dim {Dout} not divisible by n_heads {H}")
        self.in_dim, self.n_heads = in_dim, n_heads
        self.use_norm, self.use_rte = use_norm, use_rte
        self.edge_bf16, self.seg_pallas = edge_bf16, seg_pallas
        self.save_kv, self.dropout = save_kv, dropout
        # "" off | "on" unguarded | "auto" guarded per batch
        self.softmax_tilemax = softmax_tilemax
        self.softmax_pallas = softmax_pallas
        self.edge_bwd = edge_bwd  # permute | recompute | src_direct | slab

        def p(*shape, init):
            t = torch.empty(shape)
            if init == "lecun":
                lecun_normal_(t, generator)
            elif init == "glorot":
                glorot_(t, generator)
            else:
                t.fill_(init)
            return nn.Parameter(t)

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
        # learnable per-type skip gate, init 1 (conv.py:47)
        self.skip = p(T, init=1.0)
        if use_norm:
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
        return self.rte_table @ self.rte_w + self.rte_b

    def _core(self, x, se, em, **kw):
        return hgt_conv_core_sorted(
            x, se, em,
            wq=self.wq, bq=self.bq, wk=self.wk, bk=self.bk,
            wv=self.wv, bv=self.bv,
            rel_pri=self.rel_pri, rel_att=self.rel_att, rel_msg=self.rel_msg,
            n_heads=self.n_heads,
            rte_vec=self.rte_vectors() if self.use_rte else None,
            edge_dtype=torch.bfloat16 if self.edge_bf16 else None,
            seg_pallas=self.seg_pallas,
            softmax_pallas=self.softmax_pallas, **kw,
        )

    @torch.no_grad()
    def attention_weights(self, x, se, em):
        """``[E, H]`` softmax attention per edge, in ``se``'s sorted edge
        order (the reference keeps it on the module for visualization,
        ``pyHGT/conv.py:106-108``). It rides the production core with
        ``return_attention``, so the weights are the forward's by
        construction; as in the JAX package, the shift-scan or kernel
        softmax computes them, whatever ``softmax_tilemax`` says."""
        return self._core(x, se, em, return_attention=True)[1]

    def forward(self, x, node_mask, se, em, generator=None):
        aggr = self._core(
            x, se, em, save_kv=self.save_kv,
            softmax_tilemax=self.softmax_tilemax, edge_bwd=self.edge_bwd)
        # update half (conv.py:114-134): exact (erf) gelu as the reference's
        # F.gelu (conv.py:119), per-type A linear, sigmoid skip gate, norm
        trans = typed_linear(F.gelu(aggr), self.wa, self.ba)
        trans = dropout(trans, self.dropout, self.training, generator)
        alpha = torch.sigmoid(self.skip)[:, None, None]
        out = trans * alpha + x * (1.0 - alpha)
        if self.use_norm:
            out = _typed_layer_norm(out, self.ln_scale, self.ln_bias)
        return out * node_mask[..., None]
