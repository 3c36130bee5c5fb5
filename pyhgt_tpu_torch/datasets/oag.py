"""OAG raw-TSV preprocessing → CSRGraph.

A copy of :mod:`pyhgt_tpu.datasets.oag` (host numpy and, in the title
embedder, torch; ``transformers`` is imported only by
:func:`xlnet_title_embedder`, whose weights are a download): a rebuild
of the reference's ``OAG/preprocess_OAG.py``:

- citation-count filter ``cites >= min(2020 - year, 20) * citation_bar``,
  plus non-empty id/time/title, venue-or-language present, year >= 1900
  (``:62-67``);
- paper title embeddings from XLNet-base (attention-weighted 2nd-to-last
  hidden states, titles truncated to 64 tokens, ``:82-102``) — pluggable
  here so tests and offline runs can inject any embedder;
- relation families: ``PV_{venue_type}`` (en-language, embedded papers
  with known venues only, ``:127-143``), time-ordered ``PP_cite``
  (``:150-164``), ``FF_in`` field hierarchy (``:183-203``),
  ``PF_in_{level}`` (``:206-221``), author–affiliation ``in`` (``:224-
  244``), author order ``AP_write_first/last/other`` (``:246-258``);
- pretrained venue/field/affiliation vectors (``node_emb``) and node
  names (``:260-295``);
- citation rollups per type (``:300-337``);
- paper-embedding propagation to venue/field/author via row-normalized
  averaging over train-time (``<= 2016``) edges, affiliation via authors
  (``:341-393``).

File layout (tab-separated, first line is a header except vfi/SeqName):
  Papers{domain}_20190919.tsv   id, year, title, venue_id, lang, ..., venue_type, ?
  PR{domain}_20190919.tsv       citing_id, cited_id
  PF{domain}_20190919.tsv       paper_id, field_id
  FHierarchy_20190919.tsv       child_id, parent_id, child_level, parent_level
  PAuAf{domain}_20190919.tsv    paper_id, author_id, affiliation_id, ..., position
  vfi_vector.tsv                node_id, space-separated vector
  SeqName{domain}_20190919.tsv  node_id, name, node_type
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pyhgt_tpu_torch.datasets.propagate import propagate_features
from pyhgt_tpu_torch.graph.container import Graph
from pyhgt_tpu_torch.graph.csr import CSRGraph

VENUE_TYPES = ("conference", "journal", "repository", "patent")
TEST_TIME_BAR = 2016
XLNET_DIM = 768


def make_title_embedder(model, tokenizer, device: str = "cpu") -> Callable:
    """The reference featurizer's pooling math (``OAG/preprocess_OAG.py:
    82-102``), model-agnostic: attention-weighted 2nd-to-last hidden
    states over the first 64 title tokens. ``model(ids)`` must expose the
    transformers tuple API — ``out[-2]`` = per-layer hidden states,
    ``out[-1]`` = per-layer attentions (any model with
    ``output_hidden_states/output_attentions`` works; the test suite
    drives it with a tiny mock). Returns ``None`` for titles shorter
    than 4 tokens (the reference skips them)."""

    def embed(title: str):
        ids = torch.tensor([tokenizer.encode(title)]).to(device)[:, :64]
        if ids.shape[1] < 4:
            return None
        with torch.no_grad():
            out = model(ids)
        hidden, attn = out[-2], out[-1]
        rep = (
            hidden[-2][0] * attn[-2][0].mean(dim=0).mean(dim=0).view(-1, 1)
        ).sum(dim=0)
        return rep.cpu().numpy()

    return embed


def xlnet_title_embedder(device: str = "cpu", batch_hint: int = 1) -> Callable:
    """The reference's XLNet featurizer (``:82-102``): pretrained
    xlnet-base-cased through :func:`make_title_embedder`. Gated on the
    transformers package + downloadable weights."""
    from transformers import XLNetModel, XLNetTokenizer

    tokenizer = XLNetTokenizer.from_pretrained("xlnet-base-cased")
    model = XLNetModel.from_pretrained(
        "xlnet-base-cased", output_hidden_states=True, output_attentions=True
    ).to(device)
    model.eval()
    return make_title_embedder(model, tokenizer, device)


def _read_tsv(path: str, skip_header: bool = True):
    with open(path) as fin:
        if skip_header:
            fin.readline()
        for line in fin:
            yield line.rstrip("\n").split("\t")


def preprocess_oag(
    input_dir: str,
    domain: str = "_CS",
    citation_bar: int = 1,
    title_embedder: Optional[Callable] = None,
    emb_dim: int = XLNET_DIM,
    test_time_bar: int = TEST_TIME_BAR,
    log: Callable[[str], None] = print,
) -> CSRGraph:
    """Run the full pipeline; returns the frozen CSRGraph with per-type
    feature columns (emb / node_emb / citation / name)."""
    p = lambda name: os.path.join(input_dir, name)
    suffix = f"{domain}_20190919.tsv"

    # -- citation counts (:35-42) --
    cite_dict: Dict[str, int] = defaultdict(int)
    for tokens in _read_tsv(p(f"PR{suffix}")):
        cite_dict[tokens[1]] += 1

    # -- paper nodes + filter (:49-70) --
    paper_nodes: Dict[str, dict] = {}
    for tokens in _read_tsv(p(f"Papers{suffix}")):
        paper_id, time, title = tokens[0], tokens[1], tokens[2]
        venue_id, lang = tokens[3], tokens[4]
        if paper_id == "" or time == "" or title == "":
            continue
        bound = min(2020 - int(time), 20) * citation_bar
        if cite_dict[paper_id] < bound or (venue_id == "" and lang == "") or \
                int(time) < 1900:
            continue
        paper_nodes[paper_id] = {
            "id": paper_id, "title": title, "type": "paper", "time": int(time)
        }
    log(f"papers passing filter: {len(paper_nodes):,}")

    # -- title embeddings (:82-102); pluggable --
    if title_embedder is not None:
        for node in paper_nodes.values():
            emb = title_embedder(node["title"])
            if emb is not None:
                node["emb"] = np.asarray(emb, dtype=np.float32)
    else:  # offline-stub: zero embeddings, same shapes
        import warnings

        msg = (
            "preprocess_oag: no title_embedder given — paper 'emb' columns "
            f"are ZERO stubs ({emb_dim}-d). The reference pipeline fills "
            "them with XLNet attention-pooled title embeddings "
            "(OAG/preprocess_OAG.py:82-102); models trained on stubbed "
            "features will differ materially. Pass "
            "title_embedder=xlnet_title_embedder() (needs downloadable "
            "weights) or any make_title_embedder-compatible callable."
        )
        warnings.warn(msg, stacklevel=2)
        log(f"WARNING: {msg}")
        for node in paper_nodes.values():
            node["emb"] = np.zeros(emb_dim, dtype=np.float32)

    # -- pretrained vfi ids (:106-117) --
    vfi_ids: Dict[str, bool] = {}
    for tokens in _read_tsv(p("vfi_vector.tsv"), skip_header=False):
        vfi_ids[tokens[0]] = True

    graph = Graph()
    # -- PV_{venue_type} (:127-143) --
    remaining = []
    for tokens in _read_tsv(p(f"Papers{suffix}")):
        paper_id, venue_id, lang = tokens[0], tokens[3], tokens[4]
        if (paper_id not in paper_nodes) or lang != "en" or \
                ("emb" not in paper_nodes[paper_id]) or venue_id not in vfi_ids:
            continue
        remaining.append(paper_id)
        venue_type = tokens[-2]
        venue_node = {"id": venue_id, "type": "venue", "attr": venue_type}
        graph.add_edge(
            paper_nodes[paper_id], venue_node, time=int(tokens[1]),
            relation_type="PV_" + venue_type,
        )
    paper_nodes = {pid: paper_nodes[pid] for pid in remaining}
    log(f"papers with venue+emb: {len(paper_nodes):,}")

    # -- time-ordered PP_cite (:150-164) --
    for tokens in _read_tsv(p(f"PR{suffix}")):
        p1, p2 = tokens[0], tokens[1]
        if p1 in paper_nodes and p2 in paper_nodes:
            n1, n2 = paper_nodes[p1], paper_nodes[p2]
            if n1["time"] >= n2["time"]:
                graph.add_edge(n1, n2, time=n1["time"], relation_type="PP_cite")

    # -- field hierarchy + paper-field (:167-221) --
    ffl: Dict[str, object] = {}
    for tokens in _read_tsv(p(f"PF{suffix}")):
        if tokens[0] in paper_nodes and tokens[1] in vfi_ids:
            ffl[tokens[1]] = True
    for tokens in _read_tsv(p("FHierarchy_20190919.tsv")):
        f1, f2, child_level, parent_level = tokens[0], tokens[1], tokens[2], tokens[3]
        if f1 in ffl and f2 in ffl:
            n1 = {"id": f1, "type": "field", "attr": child_level}
            n2 = {"id": f2, "type": "field", "attr": parent_level}
            graph.add_edge(n1, n2, relation_type="FF_in")
            ffl[f1] = n1
            ffl[f2] = n2
    for tokens in _read_tsv(p(f"PF{suffix}")):
        paper_id, field_id = tokens[0], tokens[1]
        if paper_id in paper_nodes and isinstance(ffl.get(field_id), dict):
            pn = paper_nodes[paper_id]
            fn = ffl[field_id]
            graph.add_edge(
                pn, fn, time=pn["time"], relation_type="PF_in_" + fn["attr"]
            )

    # -- author-affiliation + ordered author-paper (:224-258) --
    paper_authors: Dict[str, Dict[int, dict]] = defaultdict(dict)
    for tokens in _read_tsv(p(f"PAuAf{suffix}")):
        paper_id, author_id, affiliation_id = tokens[0], tokens[1], tokens[2]
        if paper_id in paper_nodes and affiliation_id in vfi_ids:
            author_node = {"id": author_id, "type": "author"}
            affiliation_node = {"id": affiliation_id, "type": "affiliation"}
            paper_authors[paper_id][int(tokens[-1])] = author_node
            graph.add_edge(author_node, affiliation_node, relation_type="in")
    for paper_id, seq in paper_authors.items():
        pn = paper_nodes[paper_id]
        max_seq = max(seq.keys())
        for seq_i, author_node in seq.items():
            rel = (
                "AP_write_first" if seq_i == 1
                else "AP_write_last" if seq_i == max_seq
                else "AP_write_other"
            )
            graph.add_edge(author_node, pn, time=pn["time"], relation_type=rel)

    # -- vfi vectors + names (:260-295) --
    for tokens in _read_tsv(p("vfi_vector.tsv"), skip_header=False):
        node_id, vec = tokens[0], tokens[1]
        for node_type in ("venue", "field", "affiliation"):
            fwd = graph.node_forward.get(node_type, {})
            if node_id in fwd:
                graph.node_attrs[node_type][fwd[node_id]]["node_emb"] = np.array(
                    vec.split(" "), dtype=np.float32
                )
    for tokens in _read_tsv(p(f"SeqName{suffix}"), skip_header=False):
        node_id, name, node_type = tokens[0], tokens[1], tokens[2]
        if node_type in VENUE_TYPES:
            node_type = "venue"
        if node_type == "fos":
            node_type = "field"
        fwd = graph.node_forward.get(node_type, {})
        if node_id in fwd:
            graph.node_attrs[node_type][fwd[node_id]]["name"] = name

    # -- citation rollups (:300-337) --
    el = graph.edge_list
    cite_rows = el.get("paper", {}).get("paper", {}).get("PP_cite", {})
    for idx, node in enumerate(graph.node_attrs.get("paper", [])):
        node["citation"] = len(cite_rows.get(idx, {}))
    for idx, node in enumerate(graph.node_attrs.get("author", [])):
        c = 0
        for rel, rows in el.get("author", {}).get("paper", {}).items():
            for pidx in rows.get(idx, {}):
                c += graph.node_attrs["paper"][pidx]["citation"]
        node["citation"] = c
    for idx, node in enumerate(graph.node_attrs.get("affiliation", [])):
        c = 0
        rows = el.get("affiliation", {}).get("author", {}).get("in", {})
        for aidx in rows.get(idx, {}):
            c += graph.node_attrs["author"][aidx]["citation"]
        node["citation"] = c
    for t in ("venue", "field"):
        for idx, node in enumerate(graph.node_attrs.get(t, [])):
            c = 0
            for rel, rows in el.get(t, {}).get("paper", {}).items():
                for pidx in rows.get(idx, {}):
                    c += graph.node_attrs["paper"][pidx]["citation"]
            node["citation"] = c

    # -- feature assembly + propagation (:341-393) --
    _assemble_features(graph, emb_dim, test_time_bar)
    return graph.freeze()


def _assemble_features(graph: Graph, emb_dim: int, test_time_bar: int) -> None:
    papers = graph.node_attrs.get("paper", [])
    paper_emb = np.stack(
        [np.asarray(n.get("emb", np.zeros(emb_dim)), dtype=np.float32)
         for n in papers]
    ) if papers else np.zeros((0, emb_dim), np.float32)

    def cols(node_list, extra):
        out = {
            "citation": np.array(
                [n.get("citation", 0) for n in node_list], dtype=np.float64
            ),
            "name": np.array([str(n.get("name", "")) for n in node_list]),
        }
        out.update(extra)
        return out

    graph.node_feature["paper"] = cols(
        papers,
        {
            "emb": paper_emb,
            # titles ride along for the reference's `texts` output
            # (pyHGT/utils.py:68-69; surfaced via features.texts_oag)
            "title": np.array([str(n.get("title", "")) for n in papers]),
        },
    )

    def prop_from(tgt_type: str, src_type: str, src_emb: np.ndarray,
                  time_filtered: bool):
        node_list = graph.node_attrs.get(tgt_type, [])
        if not node_list:
            return None
        pairs_t, pairs_s = [], []
        for rel, rows in graph.edge_list.get(tgt_type, {}).get(src_type, {}).items():
            for tidx, srcs in rows.items():
                for sidx, tm in srcs.items():
                    if time_filtered and tm is not None and tm > test_time_bar:
                        continue
                    pairs_t.append(tidx)
                    pairs_s.append(sidx)
        if not pairs_t:
            emb = np.zeros((len(node_list), src_emb.shape[1]), np.float32)
        else:
            emb = propagate_features(
                (np.asarray(pairs_t), np.asarray(pairs_s)), src_emb,
                len(node_list),
            )
        node_emb = np.stack([
            np.asarray(n.get("node_emb", np.zeros(400)), dtype=np.float32)
            for n in node_list
        ])
        graph.node_feature[tgt_type] = cols(
            node_list, {"emb": emb, "node_emb": node_emb}
        )
        return emb

    for t in graph.node_attrs:
        if t in ("paper", "affiliation"):
            continue
        prop_from(t, "paper", paper_emb, time_filtered=True)
    if "author" in graph.node_feature and "affiliation" in graph.node_attrs:
        author_emb = graph.node_feature["author"]["emb"]
        prop_from("affiliation", "author", author_emb, time_filtered=False)
