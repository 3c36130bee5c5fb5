"""The plain reference of an HGT training loss, in plain PyTorch.

pyHGT's equations (``conv.py:11-139``, ``model.py:3-80``), per edge from
source ``j`` (type ``s``) to target ``i`` (type ``t``) of relation ``r``:

    rte(dt) = sin_table[dt] @ rte_w + rte_b
    k_e     = ((x_j + rte(dt)) @ wk[s] + bk[s]) @ rel_att[r]    (per head)
    v_e     = ((x_j + rte(dt)) @ wv[s] + bv[s]) @ rel_msg[r]
    q_i     = x_i @ wq[t] + bq[t]
    att_e   = <q_i, k_e> * rel_pri[r] / sqrt(dk)   softmax over i's edges
    aggr_i  = sum_e w_e * v_e
    out_i   = LN_t(sig(skip_t) * drop(gelu(aggr_i) @ wa[t] + ba[t])
                   + (1 - sig(skip_t)) * x_i)        (LN if the layer has it)

with the input ``h = drop(tanh(feat @ adapt_w[t] + adapt_b[t]))`` and a
log-softmax head. Since ``(x + rte) @ W = x @ W + rte @ W``, the key and
value of an edge are a per-node table plus a per-(relation, dt) table;
the configuration's ``edge_products = bfloat16`` says that these two
tables, the query, the per-edge key and value (their sum) and the
weighted messages are bfloat16, while the scores, the softmax and every
sum are float32. The reference rounds at exactly those places. Every
product of the node level is float32 with TF32 off. A control run puts
the reference in the program's place one precision below what the
configuration states: the node products' inputs at TF32, or the edge
stage at fp8 (:class:`Precision`).

Dropout keeps an element where ``rand >= p`` (scaled by ``1 / (1 - p)``)
for ``rand`` drawn from the step's generator over the padded ``[T, C,
n_hid]`` block, first for the input, then once per layer: the training
stream as the configuration's runner seeds it.

Imports nothing of the program; reads parameters from a ``{name:
tensor}`` dict under the architecture's names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.batch import RTE_LEN, RefBatch, relation_ids


def sin_table(d: int, length: int = RTE_LEN) -> torch.Tensor:
    """pyHGT ``RelTemporalEncoding`` (``conv.py:283-299``): sin on even
    columns, cos on odd ones, over ``1 / sqrt(d)``; float64, then f32."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64)
                 * -(np.log(10000.0) / d))
    t = np.zeros((length, d), dtype=np.float64)
    t[:, 0::2] = np.sin(pos * div)
    t[:, 1::2] = np.cos(pos * div[: d - d // 2])
    return torch.from_numpy((t / np.sqrt(d)).astype(np.float32))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even), kept in
    f32, through a straight-through gradient."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    r = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 (3 mantissa bits, saturating at 448),
    kept in f32, through a straight-through gradient."""
    r = x.detach().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()
    return x + (r - x).detach()


CONTROLS = ("tf32", "fp8")
# the ``conv_name`` values this module models
CONVS = ("hgt",)


class Precision:
    """Where the reference rounds: the edge stage at bf16 when the
    configuration states it, and for a control run either the node
    products' inputs at TF32 (``"tf32"``, below their float32) or the edge
    stage at fp8 e4m3 (``"fp8"``, below its bfloat16)."""

    def __init__(self, edge_bf16: bool, control: str = ""):
        if control and control not in CONTROLS:
            raise ValueError(f"control {control!r} not in {CONTROLS}")
        self.edge = torch.bfloat16 if edge_bf16 else torch.float32
        self.control = control

    def mm(self, a, b):
        if self.control == "tf32":
            a, b = tf32(a), tf32(b)
        return a @ b

    def einsum(self, eq, a, b):
        if self.control == "tf32":
            a, b = tf32(a), tf32(b)
        return torch.einsum(eq, a, b)

    def edge_round(self, x):
        """``x`` at the edge stage's precision: a bf16 tensor (so that a
        product with another rounds once, as the configuration's bf16
        products do), or f32 values rounded to fp8 under that control."""
        if self.control == "fp8":
            return fp8(x.float())
        return x.to(self.edge)


def _rounded(x, prec):
    """``x`` rounded to the edge precision and held in f32."""
    return prec.edge_round(x).float()


def _dropout(x, keep, p):
    return x * keep / (1.0 - p)


def _layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def dropout_masks(gen: Optional[torch.Generator], n_types: int, node_cap: int,
                  n_hid: int, n_layers: int, p: float, device) -> List:
    """The keep masks of one step: the input's, then each layer's."""
    if gen is None or p == 0.0:
        return [None] * (n_layers + 1)
    return [torch.rand((n_types, node_cap, n_hid), generator=gen,
                       device=device) >= p for _ in range(n_layers + 1)]


def forward(params: Dict[str, torch.Tensor], batch: RefBatch, cfg: dict,
            metas, prec: Precision, masks: List, device,
            taps: Optional[dict] = None) -> torch.Tensor:
    """Log-probabilities of the head's rows: every valid target-type row
    (``head = full``) or the first ``batch_size`` of them (``seeds``).
    ``taps["input"]`` receives the first layer's input, per type in
    ``batch.types`` order."""
    types = batch.types
    tix = {t: i for i, t in enumerate(types)}
    rel_id = relation_ids(metas)
    D, H, L = cfg["n_hid"], cfg["n_heads"], cfg["n_layers"]
    dk = D // H
    p = cfg["dropout"]
    n = batch.n

    def feat(t):
        return torch.as_tensor(batch.feat[t], device=device)

    h = {}
    for t in types:
        i = tix[t]
        y = torch.tanh(prec.mm(feat(t), params["gnn.adapt_w"][i])
                       + params["gnn.adapt_b"][i])
        if masks[0] is not None:
            y = _dropout(y, masks[0][i, :n[t]], p)
        h[t] = y
    if taps is not None:
        taps["input"] = [h[t] for t in types]
    blocks = []
    for b in batch.blocks:
        blocks.append((b, torch.as_tensor(b.tgt, device=device),
                       torch.as_tensor(b.src, device=device),
                       torch.as_tensor(b.dt, device=device)))
    table = sin_table(D).to(device)
    for li in range(L):
        pre = f"gnn.convs.{li}."
        P = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        rte = prec.mm(table, P["rte_w"]) + P["rte_b"]           # [L, D]
        q = {t: prec.mm(h[t], P["wq"][tix[t]]) + P["bq"][tix[t]] for t in types}
        k = {t: prec.mm(h[t], P["wk"][tix[t]]) + P["bk"][tix[t]] for t in types}
        v = {t: prec.mm(h[t], P["wv"][tix[t]]) + P["bv"][tix[t]] for t in types}
        att = {t: [] for t in types}
        vals = {t: [] for t in types}
        tgts = {t: [] for t in types}
        for b, tgt, src, dt in blocks:
            if len(b.tgt) == 0:
                continue
            r = rel_id[b.rel]
            s, tt = tix[b.src_type], b.tgt_type

            def rel_tr(x, w):
                return prec.einsum("nhk,hkl->nhl", x.view(-1, H, dk), w) \
                    .reshape(-1, D)

            # the tables rounded to the edge precision, gathered in f32 (a
            # gather's backward sums its rows: every sum stays f32), the
            # per-edge key and value rounded again after their sum
            k_node = _rounded(rel_tr(k[b.src_type], P["rel_att"][r]), prec)
            v_node = _rounded(rel_tr(v[b.src_type], P["rel_msg"][r]), prec)
            k_tab = _rounded(rel_tr(prec.mm(rte, P["wk"][s]),
                                    P["rel_att"][r]), prec)
            v_tab = _rounded(rel_tr(prec.mm(rte, P["wv"][s]),
                                    P["rel_msg"][r]), prec)
            k_e = prec.edge_round(k_node[src] + k_tab[dt])
            v_e = prec.edge_round(v_node[src] + v_tab[dt])
            q_e = _rounded(q[tt], prec)[tgt]
            score = (q_e.float() * k_e.float()).view(-1, H, dk).sum(-1)
            att[tt].append(score / math.sqrt(dk) * P["rel_pri"][r])
            vals[tt].append(v_e)
            tgts[tt].append(tgt)
        new = {}
        for t in types:
            i = tix[t]
            aggr = torch.zeros((n[t], D), device=device)
            if att[t]:
                a = torch.cat(att[t])                            # [E, H]
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
            trans = prec.mm(F.gelu(aggr), P["wa"][i]) + P["ba"][i]
            if masks[li + 1] is not None:
                trans = _dropout(trans, masks[li + 1][i, :n[t]], p)
            alpha = torch.sigmoid(P["skip"][i])
            out = trans * alpha + h[t] * (1.0 - alpha)
            if "ln_scale" in P:
                out = _layer_norm(out, P["ln_scale"][i], P["ln_bias"][i])
            new[t] = out
        h = new
    rows = h[cfg["target_type"]]
    if cfg["head"] == "seeds":
        rows = rows[: cfg["batch_size"]]
    logits = prec.mm(rows, params["clf.linear.weight"].T) \
        + params["clf.linear.bias"]
    return torch.log_softmax(logits, dim=-1)


def loss(logp: torch.Tensor, batch: RefBatch, cfg: dict, device):
    """Masked NLL over the split's rows (ogbn-mag) or KL against the
    normalised multi-hot labels over the seeds (paper-field), averaged
    over the live rows."""
    rows = logp.shape[0]
    mask = torch.as_tensor(batch.label_mask[:rows], device=device).float()
    if cfg["loss"] == "nll":
        lab = torch.as_tensor(batch.labels[:rows], device=device)
        per = -logp.gather(1, lab[:, None])[:, 0]
    else:
        t = torch.as_tensor(batch.labels[:rows], device=device)
        logt = torch.where(t > 0, torch.log(torch.clamp(t, min=1e-30)),
                           torch.zeros_like(t))
        per = (t * (logt - logp)).sum(-1)
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1)
