"""Sampling-based evaluation: variance-reduce & sequential modes.

Counterpart of :mod:`pyhgt_tpu.tasks.evaluate` (numpy only, copied as it
is but for one repair: the sampling thread pool of ``n_prefetch`` is shut
down in a ``finally``, so a forward that raises leaves no live threads).

Parity with the reference's ``ogbn-mag/eval_ogbn_mag.py``:

- **variance_reduce** (``:128-160``): resample each test batch ``vr_num``
  times with different sampler seeds, run the (deterministic) forward, and
  accumulate per-node log-prob predictions across resamples; the final
  prediction per node is the argmax of the accumulated scores
  (``:182-191``). This multi-sample averaging produced the published
  0.5007 (``README.md:28``).
- **sequential** (``:163-179``): ONE resample per test batch, but still
  per-node accumulate-then-argmax — every split-member paper appearing in
  a subgraph (seed or periphery, ``yindxs = indxs['paper'][test_mask]``,
  ``:80``) contributes to its node's accumulated score. The published
  0.4940 sequential baseline is THIS protocol, not a per-forward-pass
  running accuracy.

Both are expressed through one function; ``vr_num=1`` = sequential. The
JAX package's analysis (``docs/runs/vr_inversion_memo.md``) showed that the
per-occurrence running average previously reported as
``single_sample_acc`` is NOT the sequential protocol: it weights each
(node, appearance) pair equally, over-weighting well-connected papers
that recur as periphery context, and is therefore not comparable to the
per-node VR accuracy. To make the comparison airtight, one call now
computes, from the same forward passes:

- ``acc``            — VR per-node accuracy (reference ``:182-191``);
- ``seq_acc``        — sequential per-node accuracy from resample 0 only
                       (exactly what a ``vr_num=1`` run would produce);
- ``vr_curve``       — per-node accuracy after k=1..vr_num resamples;
- ``seed_vr_acc`` / ``seed_seq_acc`` — same two protocols restricted to
                       seed-context predictions (rows < batch seed count);
- ``seed_occ_acc`` / ``peri_occ_acc`` — per-occurrence accuracy split by
                       seed vs periphery context (the deconfounder);
- ``seed_agreement`` — mean fraction of a seed's vr_num predictions that
                       match its modal prediction (resample diversity);
- ``resample_dup_frac`` — fraction of resamples whose live target-id set
                       equals resample 0's (detects correlated seeds).

With ``n_prefetch > 0`` sampling runs on host threads while the device
evaluates — the same overlap the reference gets from its mp.Pool.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def multi_sample_eval(
    forward: Callable,       # (params, *batch_args) -> [C, n_classes] logp
    params,
    task,                    # OgbnNodeTask-like: .sample/.y/.masks/.n_classes
    split: str = "test",
    batch_size: int = 128,
    vr_num: int = 8,
    rng: Optional[np.random.Generator] = None,
    max_nodes: Optional[int] = None,
    shuffle: bool = True,
    seed_nodes: Optional[np.ndarray] = None,
    return_arrays: bool = False,
    n_prefetch: int = 0,
) -> dict:
    """Returns the stats documented in the module docstring.

    ``single_sample_acc`` (per-occurrence running average over all live
    rows) is kept for continuity with earlier run artifacts, but
    ``seq_acc`` is the comparable sequential baseline.

    ``forward(params, *batch_args)`` returns host log-probs of one
    ``TaskBatch``; ``params`` is passed through (the port's model, e.g.
    ``OgbnPredictor.params``).

    ``seed_nodes``: explicit seed list (overrides split/shuffle/
    max_nodes) — a sharded full-protocol runner hands each process its
    slice of the split.
    ``return_arrays``: additionally return the compact per-split-node
    accumulators so disjoint-seed shards merge EXACTLY (scores sum,
    seen masks OR, counters add).
    ``n_prefetch > 0``: overlap host-side ``task.sample`` with the
    device forward on a small thread pool (the serial loop spends
    ~half its wall in sampling). Each (batch, resample) job draws from
    its own ``rng.spawn()`` child, so results are deterministic given
    ``rng`` but differ from the serial stream.
    """
    rng = rng or np.random.default_rng()
    if seed_nodes is not None:
        nodes = np.asarray(seed_nodes)
    else:
        nodes = np.where(task.masks[split])[0]
        if shuffle:
            nodes = nodes[rng.permutation(len(nodes))]
        if max_nodes is not None:
            nodes = nodes[:max_nodes]

    n_classes = task.n_classes
    # Compact per-split-node accumulators: every live row's id is a split
    # member (label_mask = masks[split][ids]), so [S, C] suffices.
    split_nodes = np.where(task.masks[split])[0]
    S = len(split_nodes)
    pos = np.full(task.y.shape[0], -1, dtype=np.int64)
    pos[split_nodes] = np.arange(S)
    y_split = task.y[split_nodes]

    K = max(int(vr_num), 1)
    # per-resample-index partial sums; prefix-summed at the end for the curve
    curve_scores = np.zeros((K, S, n_classes), dtype=np.float32)
    curve_seen = np.zeros((K, S), dtype=bool)
    seed_scores = np.zeros((S, n_classes), dtype=np.float32)
    seed_seq_scores = np.zeros((S, n_classes), dtype=np.float32)
    seed_seen = np.zeros(S, dtype=bool)
    seed_seq_seen = np.zeros(S, dtype=bool)

    single_hits = single_total = 0
    seed_hits = seed_total = peri_hits = peri_total = 0
    occ_count = np.zeros(S, dtype=np.int64)
    agree_sum, agree_n = 0.0, 0
    dup_hits = dup_total = 0
    seed_id_match = seed_id_total = 0

    # ---- batch/resample iteration, optionally with sample prefetch ----
    batches = [nodes[s : s + batch_size]
               for s in range(0, len(nodes), batch_size)]
    pool = None
    try:
        if n_prefetch > 0:
            from concurrent.futures import ThreadPoolExecutor

            jobs = [(bi, k) for bi in range(len(batches)) for k in range(K)]
            job_rngs = rng.spawn(len(jobs))
            pool = ThreadPoolExecutor(max_workers=n_prefetch)
            futs = {}

            def _submit(j):
                bi, k = jobs[j]
                futs[j] = pool.submit(
                    task.sample, batches[bi], job_rngs[j], split=split
                )

            for j in range(min(2 * n_prefetch, len(jobs))):
                _submit(j)
            next_to_submit = min(2 * n_prefetch, len(jobs))

            def get_batch(bi, k):
                nonlocal next_to_submit
                j = bi * K + k
                tb = futs.pop(j).result()
                if next_to_submit < len(jobs):
                    _submit(next_to_submit)
                    next_to_submit += 1
                return tb
        else:
            def get_batch(bi, k):
                return task.sample(batches[bi], rng, split=split)

        for bi, papers in enumerate(batches):
            n_seed = len(papers)
            seed_preds: dict = {}          # paper id -> [argmax per resample]
            base_live_ids = None
            for k in range(K):
                tb = get_batch(bi, k)
                logp = np.asarray(forward(params, *tb.batch_args))
                live = np.asarray(tb.label_mask)
                all_ids = np.asarray(tb.target_ids)
                ids = all_ids[live]
                rows = logp[live]
                p = pos[ids]
                np.add.at(curve_scores[k], p, rows.astype(np.float32))
                curve_seen[k, p] = True
                occ_count[p] += 1

                is_seed = (np.arange(len(all_ids)) < n_seed)[live]
                pred = np.argmax(rows, -1)
                lab = np.asarray(tb.labels)[live]
                hit = pred == lab
                single_hits += int(hit.sum())
                single_total += int(live.sum())
                seed_hits += int(hit[is_seed].sum())
                seed_total += int(is_seed.sum())
                peri_hits += int(hit[~is_seed].sum())
                peri_total += int((~is_seed).sum())

                sp, srows = p[is_seed], rows[is_seed].astype(np.float32)
                np.add.at(seed_scores, sp, srows)
                seed_seen[sp] = True
                if k == 0:
                    np.add.at(seed_seq_scores, sp, srows)
                    seed_seq_seen[sp] = True
                    base_live_ids = np.sort(ids)
                else:
                    dup_total += 1
                    cur = np.sort(ids)
                    if len(cur) == len(base_live_ids) and np.array_equal(
                        cur, base_live_ids
                    ):
                        dup_hits += 1
                # layout-contract sanity: seed rows carry the requested papers
                seed_id_match += int((all_ids[:n_seed] == papers).sum())
                seed_id_total += n_seed
                for pid, pr in zip(ids[is_seed], pred[is_seed]):
                    seed_preds.setdefault(int(pid), []).append(int(pr))
            for preds in seed_preds.values():
                if len(preds) > 1:
                    vals, cnt = np.unique(preds, return_counts=True)
                    agree_sum += cnt.max() / len(preds)
                    agree_n += 1
    finally:
        if pool is not None:
            # pending sampling jobs are cancelled; a running one finishes
            # and its thread exits
            pool.shutdown(wait=True, cancel_futures=True)

    def _acc(scores, seen):
        idx = np.where(seen)[0]
        if not len(idx):
            return 0.0, 0
        pred = np.argmax(scores[idx], axis=-1)
        return float((pred == y_split[idx]).mean()), int(len(idx))

    # prefix-sum the per-resample partials → accuracy after k resamples
    vr_curve = []
    run_scores = np.zeros((S, n_classes), dtype=np.float32)
    run_seen = np.zeros(S, dtype=bool)
    for k in range(K):
        run_scores += curve_scores[k]
        run_seen |= curve_seen[k]
        vr_curve.append(_acc(run_scores, run_seen)[0])
    acc, n_eval = _acc(run_scores, run_seen)
    seq_acc, n_eval_seq = _acc(curve_scores[0], curve_seen[0])
    seed_vr_acc, n_seed_eval = _acc(seed_scores, seed_seen)
    seed_seq_acc, _ = _acc(seed_seq_scores, seed_seq_seen)

    out_arrays = {}
    if return_arrays:
        out_arrays = {
            "vr_scores": run_scores, "vr_seen": run_seen,
            "seq_scores": curve_scores[0], "seq_seen": curve_seen[0],
            "seed_scores": seed_scores, "seed_seen": seed_seen,
            "seed_seq_scores": seed_seq_scores,
            "seed_seq_seen": seed_seq_seen,
            "split_nodes": split_nodes, "occ_count": occ_count,
            "counters": np.array([
                single_hits, single_total, seed_hits, seed_total,
                peri_hits, peri_total, agree_n, dup_hits, dup_total,
                seed_id_match, seed_id_total,
            ], np.int64),
            "agree_sum": np.float64(agree_sum),
        }
    return {
        **out_arrays,
        "acc": acc,
        "n_eval": n_eval,
        "seq_acc": seq_acc,
        "n_eval_seq": n_eval_seq,
        "vr_curve": vr_curve,
        "single_sample_acc": single_hits / max(single_total, 1),
        "seed_occ_acc": seed_hits / max(seed_total, 1),
        "peri_occ_acc": peri_hits / max(peri_total, 1),
        "seed_occ_total": int(seed_total),
        "peri_occ_total": int(peri_total),
        "seed_vr_acc": seed_vr_acc,
        "seed_seq_acc": seed_seq_acc,
        "n_seed_eval": n_seed_eval,
        "mean_occ_per_node": float(occ_count[occ_count > 0].mean())
        if (occ_count > 0).any() else 0.0,
        "seed_agreement": agree_sum / max(agree_n, 1),
        "resample_dup_frac": dup_hits / max(dup_total, 1),
        "seed_id_match_frac": seed_id_match / max(seed_id_total, 1),
    }
