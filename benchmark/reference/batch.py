"""The plain reference's batch: what a training step should see, worked
out again from the graph and the nodes the sampler chose, and the judge of
the program's own batch against it.

HGSampling's choice of nodes is random, so the reference takes the sampled
node ids and times (the sampler's output) and judges them: each seed comes
first with its time, no type holds more than its seeds plus ``depth x
width`` nodes, and every other node is a source of some sampled target in
the graph. Everything else is derived here from the graph alone (pyHGT
``data.py:191-250``, ``train_paper_field.py:111-137``,
``train_ogbn_mag.py:67-80``): the induced edges of every meta-relation
among the first ``C`` nodes of each type, the label-leakage mask, the
per-type self loops, ``dt = t_tgt - t_src + 120`` clipped to ``[0, 240)``,
the input features and the labels.

``graph`` is a plain dict (``types``, ``metas``, ``adj[meta] = (indptr,
src, time)``, ``features``, ``aux``, ``no_time``): numpy only, nothing
of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

TIME_SHIFT = 120
RTE_LEN = 240
SELF = "self"


def relation_ids(metas) -> Dict[str, int]:
    """pyHGT's relation ids (``data.py:237-238``): a name takes the index
    of its last meta-relation, then ``self`` the next free id."""
    rel = {}
    for i, m in enumerate(metas):
        rel[m[2]] = i
    rel[SELF] = len(rel)
    return rel


@dataclasses.dataclass
class Block:
    """The edges of one meta-relation (or one type's self loops), as local
    node indices of its target and source types."""

    tgt_type: str
    src_type: str
    rel: str
    tgt: np.ndarray
    src: np.ndarray
    dt: np.ndarray


@dataclasses.dataclass
class RefBatch:
    types: List[str]
    n: Dict[str, int]                 # valid nodes per type (<= C)
    time: Dict[str, np.ndarray]
    feat: Dict[str, np.ndarray]       # [n_t, Din] f32
    blocks: List[Block]               # metas in order, then self per type
    labels: np.ndarray                # nll: [rows] class; kl: [rows, cls]
    label_mask: np.ndarray            # [rows] bool
    node_cap: int


def _features(graph, kind: str, t: str, ids: np.ndarray) -> Optional[np.ndarray]:
    cols = graph["features"].get(t) or {}
    if kind == "mag":
        if "emb" not in cols:
            return None
        return np.asarray(cols["emb"])[ids].astype(np.float32)
    if kind == "oag":
        # pyHGT utils.py:47-70: node_emb (400, zeros if absent) | emb |
        # log10(citation + 0.01)
        n = len(ids)
        node_emb = (np.asarray(cols["node_emb"])[ids].astype(np.float32)
                    if "node_emb" in cols
                    else np.zeros((n, 400), dtype=np.float32))
        emb = np.asarray(cols["emb"])[ids].astype(np.float32)
        cit = np.log10(np.asarray(cols["citation"])[ids].astype(np.float64)
                       + 0.01).astype(np.float32)[:, None]
        return np.concatenate([node_emb, emb, cit], axis=1)
    raise ValueError(f"unknown feature kind {kind!r}")


def _rows(indptr, ids):
    """The CSR rows of ``ids`` flattened: (position in ``ids`` of each
    entry, entry index). An id past the last row has no entries."""
    pos0 = np.nonzero(ids + 1 < len(indptr))[0]
    lo, hi = indptr[ids[pos0]], indptr[ids[pos0] + 1]
    cnt = (hi - lo).astype(np.int64)
    pos = np.repeat(pos0, cnt)
    start = np.repeat(lo - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    return pos, start + np.arange(cnt.sum())


def induced(graph, meta, tgt_ids, src_ids) -> Tuple[np.ndarray, np.ndarray]:
    """Every edge of ``meta`` from a node of ``tgt_ids`` to one of
    ``src_ids``, as (target position, source position), with the graph's
    multiplicity."""
    indptr, src, _ = graph["adj"][meta]
    lut = np.full(graph["num_nodes"][meta[1]], -1, np.int64)
    lut[src_ids] = np.arange(len(src_ids))
    pos, ent = _rows(indptr, tgt_ids)
    loc = lut[src[ent]]
    keep = loc >= 0
    return pos[keep].astype(np.int64), loc[keep]


def label_pairs(graph, label_meta, hi: int):
    """pyHGT train_paper_field.py:161-177 for one split (edge time <=
    ``hi``, untimed edges left out): ``{paper: (fields, last time)}`` over
    the target-indexed reverse of ``label_meta``, and the candidate list
    (label-side nodes with an edge of ``label_meta``)."""
    lt, tt, rel = label_meta
    rev = (tt, lt, rel[4:] if rel.startswith("rev_") else "rev_" + rel)
    indptr, src, time = graph["adj"][rev]
    pairs = {}
    for p in range(len(indptr) - 1):
        lo, hi_ = indptr[p], indptr[p + 1]
        t = time[lo:hi_]
        m = (t != graph["no_time"]) & (t <= hi)
        if m.any():
            pairs[p] = (src[lo:hi_][m], int(t[m][-1]))
    cand = np.where(np.diff(graph["adj"][tuple(label_meta)][0]) > 0)[0]
    return pairs, {int(c): i for i, c in enumerate(cand)}, rev


def rebuild(graph, cfg: dict, raw_ids: Dict[str, np.ndarray],
            raw_time: Dict[str, np.ndarray], node_cap: int,
            pairs=None) -> Tuple[RefBatch, int]:
    """The reference batch for the sampled nodes ``raw_ids`` (seeds
    first) and the number of ways the sampler's choice breaks HGSampling's
    contract (seeds, their times, budget, reachability). ``pairs`` is
    :func:`label_pairs`' result for a paper-field configuration."""
    types = list(graph["types"])
    target = cfg["target_type"]
    n_seed = int(cfg["batch_size"])
    bad = 0
    full = {t: np.asarray(raw_ids.get(t, np.zeros(0, np.int64)), np.int64)
            for t in types}
    seeds = full[target][:n_seed]
    # seeds distinct and first; budget per type
    bad += int(len(np.unique(seeds)) != len(seeds))
    for t in types:
        extra = n_seed if t == target else 0
        bad += int(len(full[t]) > extra + cfg["sample_depth"]
                   * cfg["sample_width"])
    # every non-seed node is a source of some sampled target
    reached = {t: np.zeros(len(full[t]), bool) for t in types}
    reached[target][:n_seed] = True
    for meta in graph["metas"]:
        tt, st, _ = meta
        if len(full[tt]) and len(full[st]):
            _, loc = induced(graph, tuple(meta), full[tt], full[st])
            reached[st][loc] = True
    bad += int(sum((~r).sum() for r in reached.values()))

    n = {t: min(len(full[t]), node_cap) for t in types}
    ids = {t: full[t][:n[t]] for t in types}
    time = {t: np.asarray(raw_time[t], np.int64)[:n[t]] for t in types}
    feat = {}
    din = None
    for t in types:
        f = _features(graph, cfg["features"], t, ids[t]) if n[t] else None
        feat[t] = f
        if f is not None:
            din = f.shape[1]
    for t in types:
        if feat[t] is None:
            feat[t] = np.zeros((n[t], din), np.float32)

    leak = {}
    if cfg["loss"] == "kl":
        # pairs: label_pairs' (pairs, candidates, reverse meta)
        leak = {tuple(cfg["label_meta"]): "src", tuple(pairs[2]): "tgt"}
    blocks = []
    for meta in graph["metas"]:
        meta = tuple(meta)
        tt, st, rel = meta
        if not (n[tt] and n[st]):
            tgt = src = np.zeros(0, np.int64)
        else:
            tgt, src = induced(graph, meta, ids[tt], ids[st])
        if leak and meta in leak:
            side = tgt if leak[meta] == "tgt" else src
            keep = side >= n_seed
            tgt, src = tgt[keep], src[keep]
        dt = np.clip(time[tt][tgt] - time[st][src] + TIME_SHIFT, 0,
                     RTE_LEN - 1)
        blocks.append(Block(tt, st, rel, tgt, src, dt))
    for t in types:
        loc = np.arange(n[t], dtype=np.int64)
        blocks.append(Block(t, t, SELF, loc, loc,
                            np.full(n[t], TIME_SHIFT, np.int64)))

    if cfg["loss"] == "nll":
        aux = graph["aux"]
        C = node_cap
        labels = np.zeros(C, np.int64)
        mask = np.zeros(C, bool)
        pid = ids[target]
        labels[:len(pid)] = np.asarray(aux["y"]).reshape(-1)[pid]
        mask[:len(pid)] = np.asarray(aux["train_mask"]).reshape(-1)[pid]
        years = np.asarray(aux["years"]).reshape(-1)
        bad += int((time[target][:len(seeds)] != years[seeds]).sum())
    else:
        pairs_, cand, _ = pairs
        labels = np.zeros((n_seed, len(cand)), np.float32)
        for i, p in enumerate(seeds.tolist()):
            cell = pairs_.get(p)
            if cell is None:
                bad += 1
                continue
            labels[i, [cand[int(s)] for s in cell[0]]] = 1.0
            bad += int(time[target][i] != cell[1])
        s = labels.sum(axis=1, keepdims=True)
        labels = np.divide(labels, s, out=np.zeros_like(labels), where=s > 0)
        mask = np.zeros(n_seed, bool)
        mask[:len(seeds)] = True
    return RefBatch(types, n, time, feat, blocks, labels, mask, node_cap), bad


def _keys(tgt, src, dt, C):
    return (np.asarray(tgt, np.int64) * C + np.asarray(src, np.int64)) \
        * RTE_LEN + np.asarray(dt, np.int64)


def _excess(a: np.ndarray, b: np.ndarray) -> int:
    """How many entries of the multiset ``a`` the multiset ``b`` lacks."""
    ua, ca = np.unique(a, return_counts=True)
    ub, cb = np.unique(b, return_counts=True)
    idx = np.searchsorted(ub, ua)
    found = idx < len(ub)
    found[found] = ub[idx[found]] == ua[found]
    have = np.zeros(len(ua), np.int64)
    have[found] = cb[idx[found]]
    return int(np.maximum(ca - have, 0).sum())


def judge(ref: RefBatch, prog: dict, layout_blocks) -> Tuple[int, RefBatch]:
    """Count where the program's padded batch ``prog`` (host arrays
    ``node_feat``, ``node_mask``, ``edge_src``, ``edge_tgt``, ``edge_dt``,
    ``edge_mask``, ``labels``, ``label_mask``) says something else than
    ``ref``; ``layout_blocks`` are ``(tgt_type, src_type, rel, start,
    cap)`` in ``ref.blocks``' order, the program's padded places.

    Where a block holds more edges than its cap, the program keeps a
    random subset; the judge then checks the kept edges against the
    reference's and returns ``ref`` with the program's subset in that
    block (the reference cannot redraw the program's choice)."""
    C = ref.node_cap
    types = ref.types
    tid = {t: i for i, t in enumerate(types)}
    bad = 0
    nm = np.asarray(prog["node_mask"]).astype(bool)
    nf = np.asarray(prog["node_feat"])
    for t in types:
        i, k = tid[t], ref.n[t]
        bad += int((nm[i] != (np.arange(C) < k)).sum())
        bad += int((nf[i, :k] != ref.feat[t]).any(axis=1).sum())
        bad += int((nf[i, k:] != 0).any(axis=-1).sum())
    es, et = np.asarray(prog["edge_src"]), np.asarray(prog["edge_tgt"])
    ed, em = np.asarray(prog["edge_dt"]), np.asarray(prog["edge_mask"])
    used = []
    for blk, (tt, st, rel, start, cap) in zip(ref.blocks, layout_blocks):
        if (tt, st, rel) != (blk.tgt_type, blk.src_type, blk.rel):
            raise ValueError(f"layout block {(tt, st, rel)} where the "
                             f"reference has {(blk.tgt_type, blk.src_type, blk.rel)}")
        sl = slice(start, start + cap)
        m = em[sl].astype(bool)
        ptgt = et[sl][m].astype(np.int64) - tid[tt] * C
        psrc = es[sl][m].astype(np.int64) - tid[st] * C
        pdt = ed[sl][m].astype(np.int64)
        pk = _keys(ptgt, psrc, pdt, C)
        rk = _keys(blk.tgt, blk.src, blk.dt, C)
        if len(rk) <= cap:
            bad += _excess(rk, pk) + _excess(pk, rk)
            used.append(blk)
        else:
            bad += _excess(pk, rk) + abs(len(pk) - cap)
            used.append(Block(tt, st, rel, ptgt, psrc, pdt))
    lab, lm = np.asarray(prog["labels"]), np.asarray(prog["label_mask"])
    bad += int((lm.astype(bool) != ref.label_mask).sum())
    if ref.labels.ndim == 1:
        live = ref.label_mask
        bad += int((lab[live] != ref.labels[live]).sum())
    else:
        bad += int((lab != ref.labels).any(axis=1).sum())
    return bad, dataclasses.replace(ref, blocks=used)
