"""The plain reference of a DenseHGT training loss, in plain PyTorch.

pyHGT's ``DenseHGTConv`` (``conv.py:143-280``, chosen by ``GeneralConv``
with ``conv_name='dense_hgt'``, ``conv.py:309-310``) keeps HGT's typed
attention and messages (:mod:`benchmark.reference.hgt` gives them, per
edge, with the RTE) and makes the update half a transformer block. For a
target ``i`` of type ``t`` with the aggregated message ``aggr_i``:

    res_i = drop(aggr_i @ wa[t] + ba[t]) + x_i       (no gate, no gelu)
    res_i = LN_t(res_i)                               (if the layer has it)
    ffn_i = drop(gelu(res_i @ mid_w + mid_b) @ out_w + out_b)
    out_i = LN(ffn_i + res_i)

``mid`` maps D to 2D and ``out`` back, shared by every type; ``LN_t`` is
the per-type norm, ``LN`` the final one. Input adaptation, head and loss
are HGT's. Departures from pyHGT, each the program's:

- the final norm is flax's ``nn.LayerNorm``: epsilon 1e-6 and the variance
  as ``E[x^2] - E[x]^2`` clipped at 0, where pyHGT's ``out_norm`` is a torch
  ``nn.LayerNorm`` (epsilon 1e-5, the variance in two passes). The per-type
  norms are pyHGT's (epsilon 1e-5, two passes);
- the per-type norm's parameters exist whatever ``use_norm`` says (pyHGT
  builds them only with it); a layer applies the norm when the
  configuration's ``prev_norm`` (every layer but the last) or
  ``last_norm`` (the last) says so;
- dropout masks come from the step's generator over the padded ``[T, C,
  n_hid]`` block, first the input's, then per layer the update's and the
  FFN's, in that order (pyHGT draws from torch's global stream);
- the edge stage rounds where :mod:`benchmark.reference.hgt` says, under
  the configuration's ``edge_products``; every node product, the FFN's
  among them, is float32 with TF32 off (a ``tf32`` control rounds their
  inputs).

Imports nothing of the program; reads parameters from a ``{name:
tensor}`` dict under the architecture's names (``mid.weight`` is a torch
``Linear``'s ``[2D, D]``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.batch import RefBatch, relation_ids
from benchmark.reference.hgt import (  # noqa: F401 (the module's contract)
    CONTROLS,
    Precision,
    _dropout,
    _layer_norm,
    _rounded,
    loss,
    sin_table,
)

# the ``conv_name`` values this module models
CONVS = ("dense_hgt",)


def _final_norm(x, scale, bias, eps=1e-6):
    """flax ``nn.LayerNorm``: the fast variance, clipped at 0."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * (torch.rsqrt(var + eps) * scale) + bias


def _ffn(res, P, prec):
    """The shared position-wise FFN, ``gelu(res @ mid) @ out``."""
    mid = prec.mm(res, P["mid.weight"].T) + P["mid.bias"]
    return prec.mm(F.gelu(mid), P["out.weight"].T) + P["out.bias"]


def dropout_masks(gen: Optional[torch.Generator], n_types: int, node_cap: int,
                  n_hid: int, n_layers: int, p: float, device) -> List:
    """The keep masks of one step: the input's, then each layer's update
    and FFN masks."""
    if gen is None or p == 0.0:
        return [None] * (2 * n_layers + 1)
    return [torch.rand((n_types, node_cap, n_hid), generator=gen,
                       device=device) >= p for _ in range(2 * n_layers + 1)]


def _aggregate(h, P, blocks, types, rel_id, n, D, H, rte, prec, device):
    """Each type's ``aggr [n_t, D]``: HGT's attention-weighted messages
    (:func:`benchmark.reference.hgt.forward`'s, rounded alike)."""
    tix = {t: i for i, t in enumerate(types)}
    dk = D // H
    q = {t: prec.mm(h[t], P["wq"][tix[t]]) + P["bq"][tix[t]] for t in types}
    k = {t: prec.mm(h[t], P["wk"][tix[t]]) + P["bk"][tix[t]] for t in types}
    v = {t: prec.mm(h[t], P["wv"][tix[t]]) + P["bv"][tix[t]] for t in types}
    att = {t: [] for t in types}
    vals = {t: [] for t in types}
    tgts = {t: [] for t in types}

    def rel_tr(x, w):
        return prec.einsum("nhk,hkl->nhl", x.view(-1, H, dk), w).reshape(-1, D)

    for b, tgt, src, dt in blocks:
        if len(b.tgt) == 0:
            continue
        r = rel_id[b.rel]
        s, tt = tix[b.src_type], b.tgt_type
        k_node = _rounded(rel_tr(k[b.src_type], P["rel_att"][r]), prec)
        v_node = _rounded(rel_tr(v[b.src_type], P["rel_msg"][r]), prec)
        k_tab = _rounded(rel_tr(prec.mm(rte, P["wk"][s]), P["rel_att"][r]),
                         prec)
        v_tab = _rounded(rel_tr(prec.mm(rte, P["wv"][s]), P["rel_msg"][r]),
                         prec)
        k_e = prec.edge_round(k_node[src] + k_tab[dt])
        v_e = prec.edge_round(v_node[src] + v_tab[dt])
        q_e = _rounded(q[tt], prec)[tgt]
        score = (q_e.float() * k_e.float()).view(-1, H, dk).sum(-1)
        att[tt].append(score / math.sqrt(dk) * P["rel_pri"][r])
        vals[tt].append(v_e)
        tgts[tt].append(tgt)
    out = {}
    for t in types:
        aggr = torch.zeros((n[t], D), device=device)
        if att[t]:
            a = torch.cat(att[t])                                # [E, H]
            ve = torch.cat(vals[t])
            tg = torch.cat(tgts[t])
            idx = tg[:, None].expand(-1, H)
            m = torch.full((n[t], H), -torch.inf, device=device) \
                .scatter_reduce(0, idx, a, "amax", include_self=True)
            ex = torch.exp(a - m[tg])
            den = torch.zeros((n[t], H), device=device).index_add(0, tg, ex)
            w = ex / den[tg]
            msg = prec.edge_round(
                prec.edge_round(w).repeat_interleave(dk, dim=1) * ve)
            aggr = aggr.index_add(0, tg, msg.float())
        out[t] = aggr
    return out


def forward(params: Dict[str, torch.Tensor], batch: RefBatch, cfg: dict,
            metas, prec: Precision, masks: List, device,
            taps: Optional[dict] = None) -> torch.Tensor:
    """Log-probabilities of the head's rows (as
    :func:`benchmark.reference.hgt.forward`). ``taps["input"]`` receives
    the first layer's input, per type in ``batch.types`` order."""
    types = batch.types
    tix = {t: i for i, t in enumerate(types)}
    rel_id = relation_ids(metas)
    D, H, L = cfg["n_hid"], cfg["n_heads"], cfg["n_layers"]
    p = cfg["dropout"]
    n = batch.n

    h = {}
    for t in types:
        i = tix[t]
        feat = torch.as_tensor(batch.feat[t], device=device)
        y = torch.tanh(prec.mm(feat, params["gnn.adapt_w"][i])
                       + params["gnn.adapt_b"][i])
        if masks[0] is not None:
            y = _dropout(y, masks[0][i, :n[t]], p)
        h[t] = y
    if taps is not None:
        taps["input"] = [h[t] for t in types]
    blocks = [(b, torch.as_tensor(b.tgt, device=device),
               torch.as_tensor(b.src, device=device),
               torch.as_tensor(b.dt, device=device)) for b in batch.blocks]
    table = sin_table(D).to(device)
    for li in range(L):
        pre = f"gnn.convs.{li}."
        P = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        use_norm = cfg["last_norm"] if li == L - 1 else cfg["prev_norm"]
        rte = prec.mm(table, P["rte_w"]) + P["rte_b"]           # [L, D]
        aggr = _aggregate(h, P, blocks, types, rel_id, n, D, H, rte, prec,
                          device)
        drop_update, drop_ffn = masks[1 + 2 * li], masks[2 + 2 * li]
        new = {}
        for t in types:
            i = tix[t]
            trans = prec.mm(aggr[t], P["wa"][i]) + P["ba"][i]
            if drop_update is not None:
                trans = _dropout(trans, drop_update[i, :n[t]], p)
            res = trans + h[t]
            if use_norm:
                res = _layer_norm(res, P["ln_scale"][i], P["ln_bias"][i])
            ffn = _ffn(res, P, prec)
            if drop_ffn is not None:
                ffn = _dropout(ffn, drop_ffn[i, :n[t]], p)
            new[t] = _final_norm(ffn + res, P["ffn_ln.scale"],
                                 P["ffn_ln.bias"])
        h = new
    rows = h[cfg["target_type"]]
    if cfg["head"] == "seeds":
        rows = rows[: cfg["batch_size"]]
    logits = prec.mm(rows, params["clf.linear.weight"].T) \
        + params["clf.linear.bias"]
    return torch.log_softmax(logits, dim=-1)
