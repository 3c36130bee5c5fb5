"""Online serving: checkpoint -> warm predictor -> per-request inference.

Counterpart of :mod:`pyhgt_tpu.experiments.serving`. Node classification
(:class:`OgbnPredictor`): load a checkpoint once, then answer
``predict(node_ids)`` requests by sampling subgraphs around the requested
nodes (HGSampling), packing them (``pad_sample``), sorting their edges on
the host (C++ when it builds) and running the ``NodeClassifierModel``
forward on the device, log-probs accumulated over ``vr_num`` resamples
(the variance-reduced protocol behind the reference's published number,
``ogbn-mag/eval_ogbn_mag.py:128-160``). Link prediction
(:class:`LinkPredictor`): an author-disambiguation checkpoint's left tower
embeds a candidate author set once into a versioned
:class:`~pyhgt_tpu_torch.tasks.matcher_index.MatcherIndex`, and query
papers are answered by their top-k authors. The transports (JSON-lines
with optional request coalescing, a stdlib HTTP front-end) are the JAX
package's, unchanged.

Exposed on the CLI as
``python -m pyhgt_tpu_torch.run serve --data .. --ckpt ..
[--serve_task link]`` (JSON-lines on stdin/stdout).
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np

from pyhgt_tpu_torch import resolve_device
from pyhgt_tpu_torch.config import ExperimentConfig
import torch

from pyhgt_tpu_torch.experiments.engine import (
    OAG_SPLITS,
    _infer_in_dim,
    check_ported,
    link_setup,
    make_layout,
    make_sampler,
    make_tx,
    node_classifier,
    sorted_logprobs,
)
from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.sampling.batch import pad_sample
from pyhgt_tpu_torch.sampling.sorted_batch import sort_batch, sort_edges
from pyhgt_tpu_torch.tasks.base import gather_features
from pyhgt_tpu_torch.tasks.matcher_index import MatcherIndex
from pyhgt_tpu_torch.tasks.ogbn import OgbnNodeTask
from pyhgt_tpu_torch.train.checkpoint import load_checkpoint
from pyhgt_tpu_torch.train.step import TrainState, make_eval_step

# a predictor's stats keep the records of this many latest forwards: a
# long-lived server appends one per forward
STATS_KEEP = 4096


class OgbnPredictor:
    """Warm node-classification predictor over a checkpoint.

    Builds the same model/layout as training (:mod:`.engine`) on
    ``device`` (default ``cuda``; the CPU only when asked for), restores
    ``ckpt_path`` (:func:`~pyhgt_tpu_torch.train.checkpoint.load_checkpoint`)
    and serves in eval mode under ``torch.inference_mode``;
    ``predict_logprobs`` accumulates per-node log-probs over ``vr_num``
    independent subgraph resamples (vr_num=1 = one sample per request
    node).

    As the JAX predictor does, each batch is sorted with the default aux
    (``sort_edges`` without ``tgt_rank_cap`` or ``tab_cap``: the legacy
    target aux, which the ``live_partials`` and, under ``softmax_pallas``,
    the ``segment_softmax_partials`` kernels read) and, serving never
    differentiating, without the backward's aux.

    ``stats`` holds one record for each of the last :data:`STATS_KEEP`
    forwards: ``sample_ms`` (sampler + feature gather + ``pad_sample``;
    requests only), ``sort_ms`` (host sort), ``forward_ms`` (host->device
    copies, the forward, the log-probs back on the host) and ``edges``
    (valid edges of the batch); ``last_batch`` is the last request
    forward's :class:`~pyhgt_tpu_torch.tasks.base.TaskBatch`.

    ``eval_forward(params, *batch_args)`` and ``params`` are what
    :func:`~pyhgt_tpu_torch.experiments.engine.evaluate_ogbn` hands
    :func:`~pyhgt_tpu_torch.tasks.evaluate.multi_sample_eval`, as in the
    JAX package; ``params`` is the restored model, and evaluation and
    requests share one forward.
    """

    def __init__(
        self,
        cfg: ExperimentConfig,
        graph: CSRGraph,
        ckpt_path: str,
        log: Callable[[str], None] = print,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        check_ported(cfg)
        self.cfg = cfg
        sampler = make_sampler(cfg, graph, log=log)
        self.layout = make_layout(cfg, graph)
        self.em = EdgeStaticMeta.from_layout(self.layout)
        self.em_dev = self.em.to(self.device)
        self.task = OgbnNodeTask(
            graph=graph, sampler=sampler, layout=self.layout,
            batch_size=cfg.batch_size,
        )
        rng0 = np.random.default_rng(cfg.seed)
        tb0 = self.task.sample(np.arange(min(cfg.batch_size, 4)), rng0)
        model = node_classifier(
            cfg, self.layout, _infer_in_dim(tb0), self.task.n_classes,
            self.task.target_type).to(self.device)
        template = TrainState(model, make_tx(cfg, model.named_parameters(), 1))
        self.state = load_checkpoint(ckpt_path, template)
        self.model = self.state.model.eval()
        self.stats: list = []
        self.last_batch = None

    @property
    def n_classes(self) -> int:
        return self.task.n_classes

    @property
    def params(self):
        """The restored model (the port's parameters live in it)."""
        return self.model

    def eval_forward(self, params, nf, es, et, dt, emk, nmk) -> np.ndarray:
        """Log-probs ``[node_cap, n_classes]`` on the host of one batch
        given as ``TaskBatch.batch_args``, through ``params`` (a model of
        this predictor's shape; :attr:`params` is its own): the host sort
        without the backward's aux, then the forward in eval mode."""
        t0 = time.perf_counter()
        se = sort_edges(es, et, dt, emk, self.layout, self.em,
                        with_backward=False)
        t1 = time.perf_counter()
        logp = sorted_logprobs(make_eval_step(params), nf, nmk, se,
                               self.em_dev, self.device)
        t2 = time.perf_counter()
        self.stats.append({"sort_ms": (t1 - t0) * 1e3,
                           "forward_ms": (t2 - t1) * 1e3,
                           "edges": int(np.asarray(emk).sum())})
        del self.stats[:-STATS_KEEP]
        return logp

    def _forward(self, tb) -> np.ndarray:
        """Log-probs ``[node_cap, n_classes]`` of one sampled batch, on the
        host."""
        self.last_batch = tb
        return self.eval_forward(self.model, *tb.batch_args)

    # ------------------------------------------------------------------
    def predict_logprobs(
        self,
        node_ids: Sequence[int],
        vr_num: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        """Accumulated log-probs ``[len(node_ids), n_classes]`` over
        ``vr_num`` resamples (the VR protocol; argmax of the accumulation
        is the served prediction). Extra subgraph co-members are free
        riders: any requested node appearing in another request node's
        subgraph also contributes its row."""
        vr = max(vr_num if vr_num is not None else self.cfg.vr_num, 1)
        rng = rng or np.random.default_rng(self.cfg.seed + 9)
        ids = np.asarray(node_ids, dtype=np.int64)
        # accumulate per UNIQUE id, broadcast to duplicate request rows at
        # the end (a duplicated id must answer identically on every row)
        uniq, inv = np.unique(ids, return_inverse=True)
        acc_u = np.zeros((len(uniq), self.n_classes), dtype=np.float64)
        bs = self.cfg.batch_size
        for s in range(0, len(uniq), bs):
            chunk = uniq[s : s + bs]
            for _ in range(vr):
                t0 = time.perf_counter()
                tb = self.task.sample(chunk, rng, split="train")
                sample_ms = (time.perf_counter() - t0) * 1e3
                logp = self._forward(tb)
                self.stats[-1]["sample_ms"] = sample_ms
                tids = np.asarray(tb.target_ids)
                live = tids >= 0
                pos = np.searchsorted(uniq, tids[live])
                pos = np.minimum(pos, len(uniq) - 1)
                hit = uniq[pos] == tids[live]
                # tids are unique within one subgraph, so fancy += is safe
                acc_u[pos[hit]] += logp[live][hit]
        return acc_u[inv]

    def predict(
        self,
        node_ids: Sequence[int],
        vr_num: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        """Served class ids ``[len(node_ids)]``."""
        return np.argmax(
            self.predict_logprobs(node_ids, vr_num=vr_num, rng=rng), axis=-1
        )


def _sync(device) -> None:
    """Wait for the device, so that a host clock read after it covers the
    work queued on it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LinkPredictor:
    """Two-tower serving for the link-prediction family (author
    disambiguation): an offline candidate index and online top-k.

    The reference's Matcher caches its left tower in-module for "millions
    or even billions" of candidates and never invalidates it
    (``pyHGT/model.py:27-39``); here the flow is explicit:

    - :meth:`build_author_index` embeds a candidate author set once —
      subgraphs sampled around the authors (chunks of ``batch_size``), GNN
      representations through the matcher's LEFT tower into a versioned
      :class:`~pyhgt_tpu_torch.tasks.matcher_index.MatcherIndex` on the
      device;
    - :meth:`topk` answers query papers online: sample around the papers,
      RIGHT-tower their representations, score against the index.

    The model and layout are built as ``run_author_disambiguation`` builds
    them (calibrated caps), on ``device`` (default ``cuda``), and
    ``ckpt_path`` is restored into it. Batches are sorted with the default
    aux and without the backward's (as :class:`OgbnPredictor` sorts). No
    leakage masking at serving time: inference wants every edge (masking
    is a training concern, ``train_author_disambiguation.py:145-155``).

    ``stats`` holds one record for each of the last :data:`STATS_KEEP`
    forwards: ``sample_ms`` (sampler + feature gather + ``pad_sample``),
    ``sort_ms`` (host sort), ``forward_ms`` (host->device copies and the
    GNN forward, to the device's end), ``edges`` (valid edges), and for a
    query forward ``topk_ms`` (right tower, index product, top-k and the
    results back on the host).
    """

    def __init__(
        self,
        cfg: ExperimentConfig,
        graph: CSRGraph,
        ckpt_path: str,
        first_meta=("author", "paper", "rev_AP_write_first"),
        write_meta=("paper", "author", "AP_write_first"),
        max_group: int = 32,
        log: Callable[[str], None] = print,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        check_ported(cfg)
        self.cfg = cfg
        self.graph = graph
        task, _, model = link_setup(cfg, graph, OAG_SPLITS, first_meta,
                                    write_meta, max_group, log)
        self.task, self.layout, self.sampler = task, task.layout, task.sampler
        self.em = EdgeStaticMeta.from_layout(self.layout)
        self.em_dev = self.em.to(self.device)
        model = model.to(self.device)
        template = TrainState(model, make_tx(cfg, model.named_parameters(), 1))
        self.state = load_checkpoint(ckpt_path, template)
        self.model = self.state.model.eval()
        self._gnn = make_eval_step(self.model.gnn)
        self.max_time = int(graph.times.max()) if len(graph.times) else 0
        self.index = None
        self.stats: list = []

    def _reps(self, seed_dict, rng) -> torch.Tensor:
        """``[T, C, D]`` GNN representations of one sampled padded subgraph,
        on the device; appends the forward's record to ``stats``."""
        t0 = time.perf_counter()
        raw = self.sampler.sample_raw(seed_dict, rng=rng)
        feats = gather_features(self.graph, raw, self.task.feature_fn)
        sub = pad_sample(raw, self.layout, feats, rng=rng)
        t1 = time.perf_counter()
        se = sort_batch(sub, self.layout, self.em, with_backward=False)
        t2 = time.perf_counter()
        h = self._gnn(torch.as_tensor(sub.node_feat, device=self.device),
                      torch.as_tensor(sub.node_mask, device=self.device),
                      se.to(self.device), self.em_dev)
        _sync(self.device)
        t3 = time.perf_counter()
        self.stats.append({"sample_ms": (t1 - t0) * 1e3,
                           "sort_ms": (t2 - t1) * 1e3,
                           "forward_ms": (t3 - t2) * 1e3,
                           "edges": int(np.asarray(sub.edge_mask).sum())})
        del self.stats[:-STATS_KEEP]
        return h

    def build_author_index(
        self,
        author_ids: Sequence[int],
        rng: Optional[np.random.Generator] = None,
    ) -> "LinkPredictor":
        """Embed candidate authors (seeded at ``max_time``, the reference's
        convention ``train_author_disambiguation.py:107-131``) into the
        left-tower index. Call again after new checkpoints — the index is
        versioned, not silently stale."""
        rng = rng or np.random.default_rng(self.cfg.seed + 11)
        ids = np.asarray(author_ids, dtype=np.int64)
        a_ti = self.layout.schema.type_id(self.task.author_type)
        reps = []
        bs = self.cfg.batch_size
        for s in range(0, len(ids), bs):
            chunk = ids[s : s + bs]
            seeds = np.stack(
                [chunk, np.full(len(chunk), self.max_time)], axis=1
            )
            h = self._reps({self.task.author_type: seeds}, rng)
            reps.append(h[a_ti, : len(chunk)])  # seeds-first contract
        if self.index is None:
            self.index = MatcherIndex(
                matcher_apply=lambda m, x: m.matcher.left(x))
        self.index.build(self.model, torch.cat(reps, dim=0), ids)
        return self

    def topk(
        self,
        paper_ids: Sequence[int],
        k: int = 10,
        times: Optional[Sequence[int]] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        """Top-k candidate authors per query paper:
        ``(scores [Q, k], author_ids [Q, k])`` on the host."""
        if self.index is None:
            raise RuntimeError("call build_author_index() first")
        k = min(k, len(self.index._cand_ids))
        rng = rng or np.random.default_rng(self.cfg.seed + 13)
        ids = np.asarray(paper_ids, dtype=np.int64)
        t = (np.asarray(times, dtype=np.int64) if times is not None
             else np.full(len(ids), self.max_time))
        p_ti = self.layout.schema.type_id(self.task.paper_type)
        vals_out, cand_out = [], []
        bs = self.cfg.batch_size  # chunk: seeds beyond node_cap would be
        # silently truncated by pad_sample (sampling/batch.py)
        for s in range(0, len(ids), bs):
            seeds = np.stack([ids[s : s + bs], t[s : s + bs]], axis=1)
            h = self._reps({self.task.paper_type: seeds}, rng)
            t0 = time.perf_counter()
            with torch.inference_mode():
                q = self.model.matcher.right(h[p_ti, : len(seeds)])
            vals, cand = self.index.score(q, top_k=k)
            vals_out.append(vals.cpu().numpy())
            cand_out.append(cand)
            self.stats[-1]["topk_ms"] = (time.perf_counter() - t0) * 1e3
        return np.concatenate(vals_out), np.concatenate(cand_out)


def _answer_node_batch(predictor, reqs):
    """Answer a list of parsed node-classification requests with ONE
    predict_logprobs call per distinct vr_num (request coalescing: the
    subgraph sampler + forward amortize across concurrent requests —
    predict_logprobs already dedupes node ids and chunks by batch_size).
    Returns responses in request order."""
    import collections

    resp = [None] * len(reqs)
    groups = collections.defaultdict(list)
    for i, req in enumerate(reqs):
        try:
            nodes = [int(v) for v in req["nodes"]]
            groups[req.get("vr_num")].append((i, nodes))
        except Exception as e:  # malformed request: answer, don't die
            resp[i] = {"error": repr(e)}
    def answer_members(members, vr):
        flat = [v for _, nodes in members for v in nodes]
        lp = predictor.predict_logprobs(flat, vr_num=vr)
        pos = 0
        for i, nodes in members:
            rows = lp[pos : pos + len(nodes)]
            pos += len(nodes)
            resp[i] = {
                "nodes": nodes,
                "pred": np.argmax(rows, axis=-1).tolist(),
                "logp": np.round(rows, 6).tolist(),
            }

    for vr, members in groups.items():
        try:
            answer_members(members, vr)
        except Exception as e:
            # per-request isolation: one poison request (e.g. an
            # out-of-range node id) must not fail the whole burst — retry
            # members individually so only the bad one errors
            if len(members) == 1:
                resp[members[0][0]] = {"error": repr(e)}
                continue
            for member in members:
                try:
                    answer_members([member], vr)
                except Exception as e1:
                    resp[member[0]] = {"error": repr(e1)}
    return resp


def _serve_loop(stdin, stdout, log, answer) -> int:
    """Shared JSON-lines transport: strip / skip blank / parse / answer /
    emit+flush / count. ``answer(req) -> resp dict`` supplies the task
    semantics; parse failures and answer exceptions both come back as an
    ``{"error": ...}`` envelope so clients can json.loads every line."""
    import json
    import sys

    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    n = 0
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            resp = answer(json.loads(line))
        except Exception as e:  # malformed request: answer, don't die
            resp = {"error": repr(e)}
        stdout.write(json.dumps(resp) + "\n")
        stdout.flush()
        n += 1
    log(f"served {n} requests")
    return n


def serve_jsonl(
    predictor: OgbnPredictor,
    stdin=None,
    stdout=None,
    log: Callable[[str], None] = print,
    coalesce_wait: float = 0.0,
    deadline_ms: Optional[float] = None,
) -> int:
    """JSON-lines serving loop: each request line
    ``{"nodes": [...], "vr_num": k?}`` answers with
    ``{"nodes": [...], "pred": [...], "logp": [[...]]}``.

    ``coalesce_wait > 0`` turns on micro-batching: after the first
    pending request arrives, wait up to that many seconds for more lines,
    then answer the whole burst with one coalesced model call per
    distinct ``vr_num`` (responses stay in request order; a failing
    request is retried solo so it only errors itself). The classic
    serving-batcher trade: +wait latency on the first request of a burst,
    ~burst-size× throughput under concurrency.

    ``coalesce_wait="auto"`` (or a negative float: adaptive with
    ``max_wait=|value|``) replaces the fixed window with
    :class:`AdaptiveWait`; ``deadline_ms`` adds the arrival-anchored p95
    queueing cap (the burst closes once its oldest request has waited
    that long, however deep the backlog)."""
    coalesce_wait = _norm_wait(coalesce_wait, deadline_ms, log)
    if not isinstance(coalesce_wait, AdaptiveWait) and coalesce_wait <= 0:
        return _serve_loop(
            stdin, stdout, log,
            lambda req: _answer_node_batch(predictor, [req])[0],
        )
    return _serve_coalesced(
        stdin, stdout, log, coalesce_wait,
        lambda reqs: _answer_node_batch(predictor, reqs),
    )


def _norm_wait(coalesce_wait, deadline_ms=None, log=print):
    """0/positive float = fixed window; "auto" or negative float =
    :class:`AdaptiveWait` (max window = 20 ms or ``|value|``).
    ``deadline_ms`` (adaptive only): arrival-anchored p95 queueing cap;
    under a fixed window it has no effect, and a warning (and a line on
    ``log``) says so."""
    dl = deadline_ms / 1e3 if deadline_ms else None
    if coalesce_wait == "auto":
        return AdaptiveWait(deadline=dl)
    if isinstance(coalesce_wait, AdaptiveWait):
        if dl is not None and coalesce_wait.deadline is None:
            coalesce_wait.deadline = dl
        return coalesce_wait
    if coalesce_wait is not None and coalesce_wait < 0:
        return AdaptiveWait(max_wait=abs(coalesce_wait), deadline=dl)
    if dl is not None:
        msg = (f"deadline_ms={deadline_ms:g} is ignored: the deadline caps "
               f"adaptive coalescing only, and coalesce_wait="
               f"{coalesce_wait!r} is a fixed window (pass 'auto' or a "
               "negative value for the adaptive wait)")
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
        log(f"WARNING: {msg}")
    return coalesce_wait


class AdaptiveWait:
    """Adaptive coalescing controller (a fixed ``coalesce_wait`` taxes
    sparse traffic and under-batches bursts).

    With an :class:`AdaptiveWait` the transport collects a burst with a
    *bounded idle-gap drain* instead of sleep-then-drain: keep accepting
    requests while each next one arrives within ``gap`` seconds of the
    last, up to ``max_wait`` total. A burst that has fully arrived pays
    ONE small gap tail (<= ``gap_cap`` = max_wait/8) rather than the full
    window — the fixed-window design pays the whole window even when the
    burst is already complete, which costs it median latency on bursty
    traffic.

    ``gap`` itself is MIMD-adapted: multiplicative increase while bursts
    actually coalesce (>= 2 requests folded, bridging intra-burst arrival
    jitter up to ``gap_cap``), multiplicative decrease when requests
    arrive alone — sparse traffic converges to a ~80 us gap (no latency
    tax). A cycle that BEGINS with >= 2 requests already queued
    (``backlog``) means the previous gap split a burst, so the gap jumps
    straight to ``gap_cap`` instead of climbing.
    """

    def __init__(self, max_wait: float = 0.02,
                 deadline: Optional[float] = None):
        self.max_wait = max_wait          # total collection budget
        self.gap_cap = max_wait / 8       # idle-gap ceiling
        self.min_wait = max_wait / 256
        self.wait = self.gap_cap          # current idle gap
        # p95 queueing-delay cap: when set, the burst closes once the OLDEST request has been
        # queued `deadline` seconds — anchored at its ARRIVAL timestamp,
        # not at dequeue, so backlog under load cannot push the tail past
        # the cap. None keeps the dequeue-anchored max_wait budget only.
        self.deadline = deadline

    def next_wait(self, backlog: int = 0) -> float:
        if backlog >= 2:
            # a burst is ALREADY queued: the last gap under-batched it
            # (requests arrived during service) — jump to the ceiling
            self.wait = self.gap_cap
        return self.wait

    def observe(self, burst_size: int) -> None:
        if burst_size >= 2:
            self.wait = min(self.wait * 2, self.gap_cap)
        else:
            self.wait = max(self.wait / 2, self.min_wait)


def _serve_coalesced(stdin, stdout, log, coalesce_wait, answer_batch) -> int:
    """Micro-batching JSON-lines transport shared by the node and link
    serving loops: a reader thread queues lines; after the first pending
    request, wait ``coalesce_wait`` seconds for the burst, then answer it
    with ONE ``answer_batch(reqs) -> [resp]`` call (request order
    preserved; parse failures answer in place).

    ``coalesce_wait`` may be an :class:`AdaptiveWait` (or the string
    ``"auto"`` / a negative float at the API layer) — the window then
    adapts to the observed arrival process instead of being a constant.
    """
    import json
    import queue
    import sys
    import threading
    import time

    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    n = 0

    def emit(resp):
        nonlocal n
        stdout.write(json.dumps(resp) + "\n")
        stdout.flush()
        n += 1

    def parse(line):
        try:
            return json.loads(line)
        except Exception as e:
            return {"__parse_error__": repr(e)}

    q: "queue.Queue" = queue.Queue()
    _EOF = object()

    def reader():
        # the finally is load-bearing: if stdin raises mid-iteration
        # (broken pipe, decode error) the sentinel must still arrive or
        # the main loop blocks in q.get() forever with no diagnostic
        try:
            for line in stdin:
                line = line.strip()
                if line:
                    q.put((time.monotonic(), line))  # arrival-stamped
        except Exception as e:
            log(f"serve reader failed: {e!r}")
        finally:
            q.put(_EOF)

    threading.Thread(target=reader, daemon=True).start()
    adaptive = isinstance(coalesce_wait, AdaptiveWait)
    done = False
    while not done:
        item = q.get()
        if item is _EOF:
            break
        first_ts, first = item
        burst = [first]
        if adaptive:
            # bounded idle-gap drain: accept requests while each next one
            # arrives within `gap` of the last, up to max_wait total — a
            # fully-arrived burst pays one small gap tail instead of the
            # whole window (see AdaptiveWait)
            gap = coalesce_wait.next_wait(backlog=q.qsize())
            if coalesce_wait.deadline is not None:
                # p95 cap: anchored at the oldest request's ARRIVAL
                deadline = first_ts + coalesce_wait.deadline
            else:
                deadline = time.monotonic() + coalesce_wait.max_wait
            idle_exit = False
            while True:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    # deadline reached (or already past at dequeue, under
                    # backlog): stop WAITING, but still fold everything
                    # already queued into this burst — batching what is
                    # pending adds zero latency, and forfeiting it under
                    # saturation collapses bursts to singletons exactly
                    # when batching matters most
                    while True:
                        try:
                            item = q.get_nowait()
                        except queue.Empty:
                            break
                        if item is _EOF:
                            done = True
                            break
                        burst.append(item[1])
                    break
                try:
                    item = q.get(timeout=min(gap, rem))
                except queue.Empty:
                    idle_exit = True
                    break
                if item is _EOF:
                    done = True
                    break
                burst.append(item[1])
            if idle_exit:
                # only idle-gap-terminated bursts adapt the window: a
                # deadline- or EOF-truncated burst under-represents the
                # arrival rate and would multiplicatively grow the gap at
                # saturation
                coalesce_wait.observe(len(burst))
        else:
            time.sleep(coalesce_wait)  # let the burst accumulate
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is _EOF:
                    done = True
                    break
                burst.append(item[1])
        reqs, order = [], []
        for line in burst:
            req = parse(line)
            if "__parse_error__" in req:
                order.append({"error": req["__parse_error__"]})
            else:
                order.append(len(reqs))
                reqs.append(req)
        answers = answer_batch(reqs)
        for slot in order:
            emit(slot if isinstance(slot, dict) else answers[slot])
    log(f"served {n} requests")
    return n


def serve_http(
    answer,
    port: int = 0,
    host: str = "127.0.0.1",
    log: Callable[[str], None] = print,
):
    """Minimal stdlib HTTP front-end over the same ``answer(req) -> resp``
    semantics as the JSON-lines loops (node or link — pass the matching
    closure). POST / with a JSON body answers JSON; malformed requests
    get the ``{"error": ...}`` envelope with status 400; GET /healthz
    answers 200 once the predictor is warm (it is constructed before the
    server starts). Returns the bound ``HTTPServer`` — call
    ``serve_forever()`` (CLI) or drive it from a thread (tests).

    Requests are handled serially on one thread: predictors are not
    re-entrant (per-forward records, the device's stream), and the model call
    dominates latency anyway — put a real load balancer in front for
    fan-in, exactly like the reference's torch eval scripts would need.
    """
    import json
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # route access logs to our logger
            log(f"http: {fmt % a}")

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": "POST / with a JSON request"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
            except Exception as e:
                self._send(400, {"error": repr(e)})
                return
            try:
                self._send(200, answer(req))
            except Exception as e:
                self._send(400, {"error": repr(e)})

    srv = HTTPServer((host, port), Handler)
    log(f"serving on http://{host}:{srv.server_port}")
    return srv


def node_answer(predictor: OgbnPredictor):
    """The node-classification request semantics shared by the JSONL and
    HTTP front-ends."""
    return lambda req: _answer_node_batch(predictor, [req])[0]


def serve_link_jsonl(
    predictor: LinkPredictor,
    stdin=None,
    stdout=None,
    log: Callable[[str], None] = print,
    coalesce_wait: float = 0.0,
    deadline_ms: Optional[float] = None,
) -> int:
    """JSON-lines top-k serving on a :class:`LinkPredictor`: each line
    ``{"papers": [...], "k": 10?, "times": [...]?}`` answers with
    ``{"papers": [...], "authors": [[...k ids]], "scores": [[...k]]}``.
    A line ``{"index_authors": [...]}`` (re)builds the candidate index
    online (versioned, :meth:`LinkPredictor.build_author_index`) and
    answers ``{"indexed": n, "version": v}``.

    ``coalesce_wait > 0`` micro-batches concurrent requests into one
    subgraph sample + top-k call per distinct ``k`` (the same trade as the
    node loop; index rebuilds are never coalesced). ``"auto"`` / a
    negative float selects the :class:`AdaptiveWait` window;
    ``deadline_ms`` = arrival-anchored p95 queueing cap."""
    coalesce_wait = _norm_wait(coalesce_wait, deadline_ms, log)
    if not isinstance(coalesce_wait, AdaptiveWait) and coalesce_wait <= 0:
        return _serve_loop(stdin, stdout, log, link_answer(predictor))
    return _serve_coalesced(
        stdin, stdout, log, coalesce_wait,
        lambda reqs: _answer_link_batch(predictor, reqs),
    )


def _answer_link_batch(predictor, reqs):
    """Answer a burst of parsed link requests with ONE ``topk`` call per
    distinct ``k`` (queries concatenate; per-paper times default to the
    predictor's ``max_time`` exactly as ``topk(times=None)`` does).
    ``index_authors`` lines run in place, uncoalesced — so a rebuild
    inside a burst applies to EVERY top-k answer of that burst (clients
    needing strict ordering should not pipeline rebuilds with queries).
    Response order matches request order; a failing request retries solo
    so it only errors itself."""
    import collections

    single = link_answer(predictor)
    resp = [None] * len(reqs)
    groups = collections.defaultdict(list)
    for i, req in enumerate(reqs):
        try:
            if "index_authors" in req:
                resp[i] = single(req)
                continue
            papers = [int(v) for v in req["papers"]]
            times = req.get("times")
            if times is not None:
                times = [int(t) for t in times]
                if len(times) != len(papers):
                    raise ValueError(
                        f"times has {len(times)} entries for "
                        f"{len(papers)} papers"
                    )
            groups[int(req.get("k", 10))].append((i, papers, times))
        except Exception as e:  # malformed request: answer, don't die
            resp[i] = {"error": repr(e)}

    def answer_members(members, k):
        flat, flat_t = [], []
        for _, papers, times in members:
            flat.extend(papers)
            flat_t.extend(
                times if times is not None
                else [predictor.max_time] * len(papers)
            )
        vals, cand = predictor.topk(flat, k=k, times=flat_t)
        pos = 0
        for i, papers, _ in members:
            rows = slice(pos, pos + len(papers))
            pos += len(papers)
            resp[i] = {
                "papers": papers,
                "authors": cand[rows].tolist(),
                "scores": np.round(vals[rows], 6).tolist(),
            }

    for k, members in groups.items():
        try:
            answer_members(members, k)
        except Exception as e:
            if len(members) == 1:
                resp[members[0][0]] = {"error": repr(e)}
                continue
            for member in members:
                try:
                    answer_members([member], k)
                except Exception as e1:
                    resp[member[0]] = {"error": repr(e1)}
    return resp


def link_answer(predictor: LinkPredictor):
    """The link top-k request semantics shared by the JSONL and HTTP
    front-ends."""

    def answer(req):
        if "index_authors" in req:
            ids = [int(v) for v in req["index_authors"]]
            predictor.build_author_index(ids)
            return {
                "indexed": len(ids),
                "version": predictor.index.params_version,
            }
        papers = [int(v) for v in req["papers"]]
        vals, cand = predictor.topk(
            papers, k=int(req.get("k", 10)), times=req.get("times"),
        )
        return {
            "papers": papers,
            "authors": cand.tolist(),
            "scores": np.round(vals, 6).tolist(),
        }

    return answer
