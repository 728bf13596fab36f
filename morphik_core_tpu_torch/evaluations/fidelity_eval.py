#!/usr/bin/env python3
"""The int8 serving-mode fidelity gate on the port: twin of
`evaluations/fidelity_eval.py`, with the original's two parts, flags,
report keys and `GATE`.

A. bf16 <-> int8 RANKING AGREEMENT on real model geometry. Random bf16
   weights serve a page corpus twice, first in bf16, then quantized in
   place to W8A8 (`quantize_colqwen_params`: one 3B copy, where the
   original builds a second model from the bf16 params), and every query
   runs through the full retrieval stack on both sides (FDE -> int8 ANN
   -> pooled int8 prefilter -> exact int8 MaxSim rerank: K3 in the
   tower's windowed blocks, K1 in the rerank and the score matrix).
   Reported: top-1 match rate, top-k Jaccard overlap, Kendall tau over
   the common top-10, the exact-score Pearson and the margin-aware
   top-10 agreement.

B. FDE + int8-index RECALL AT SCALE: recall@75 of the exact-MaxSim
   top-10 over >=100k clustered synthetic rows, the FDE rows int8
   quantized per row as the index stores them, against the same rows in
   f32.

The embedder takes `Settings()`'s `model.static_act_scales` as the
original's does (False: dynamic activation scales), so the gate measures
W8A8 with dynamic scales, not the static scales `morphik_tpu.toml`
ships. The pages are drawn in Pillow's default font by
`pil_default.draw_text` and the queries recompressed at q30 by the
port's JPEG codec, pixel for pixel as the original's.

Usage:
    python -m morphik_core_tpu_torch.evaluations.fidelity_eval [--small] [--out FID.json] [--cpu]
        [--skip-part-a] [--skip-part-b] [--merge PARTIAL.json]

It runs on the card, or on the CPU with `--cpu`. Exit code 0 when the
gate passes, 1 when it does not.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from morphik_core_tpu_torch.evaluations.pil_default import draw_text

VOCAB = (
    "alpha bridge casing dynamo ember flux gasket helix ion joule kelvin "
    "lumen motor nacelle orbit piston quartz rotor stator torque"
).split()


def render_page(seed: int, w=560, h=720) -> np.ndarray:
    """The original's page: random vocabulary lines in the default font,
    as (h, w, 3) uint8 RGB."""
    r = np.random.default_rng(seed)
    page = np.full((h, w), 255, np.uint8)
    y = 10
    while y < h - 24:
        draw_text(page, (int(r.integers(6, 80)), y), " ".join(r.choice(VOCAB, r.integers(3, 10))))
        y += int(r.integers(14, 24))
    return np.repeat(page[..., None], 3, axis=2)


def perturbed(img: np.ndarray, seed: int) -> np.ndarray:
    """Gaussian noise (sigma 20), then a q30 JPEG round trip."""
    from morphik_core_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

    r = np.random.default_rng(seed)
    a = img.astype(np.float32) + r.normal(0, 20, img.shape)
    data, _ = encode_jpeg(np.clip(a, 0, 255).astype(np.uint8), quality=30)
    return decode_jpeg(data)


def kendall_tau(rank_a, rank_b) -> float:
    """Tau over items common to both rankings (lists of ids)."""
    common = [x for x in rank_a if x in set(rank_b)]
    if len(common) < 2:
        return 1.0
    pos_b = {x: i for i, x in enumerate(rank_b)}
    conc = disc = 0
    for i in range(len(common)):
        for j in range(i + 1, len(common)):
            if pos_b[common[i]] < pos_b[common[j]]:
                conc += 1
            else:
                disc += 1
    return (conc - disc) / max(conc + disc, 1)


def _device(device):
    import torch

    from morphik_core_tpu_torch.device import default_device

    return torch.device(device) if device is not None else default_device()


def _part_a(small: bool, device=None, model=None, counts=None):
    """-> (report, rankings, score matrices) of Part A. `model`: a bf16
    ColQwenModel to use (quantized in place here); default the random
    weights of `init_random(seed=0)` at the tiny or 3B geometry.
    `counts`: (pages, queries) in place of the geometry's (24, 8) or
    (240, 30), e.g. the 3B width at the small counts."""
    import torch

    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
    from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
    from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel, quantize_colqwen_params
    from morphik_core_tpu_torch.ops.fde import FDEConfig
    from morphik_core_tpu_torch.ops.maxsim import maxsim_scores_q8, quantize_pool_int8

    device = _device(device)
    cfg = ColQwenConfig.tiny() if small else ColQwenConfig()
    n_pages, n_queries = counts or ((24, 8) if small else (240, 30))
    settings = Settings()

    t0 = time.time()
    if model is None:
        model = ColQwenModel.init_random(cfg, seed=0, device=device, dtype=torch.bfloat16)
    cfg = model.cfg
    pages = [render_page(s) for s in range(n_pages)]
    queries = [perturbed(pages[i * (n_pages // n_queries)], 1000 + i) for i in range(n_queries)]
    gold = [i * (n_pages // n_queries) for i in range(n_queries)]

    def production_index(dim: int) -> MultiVectorIndex:
        # the full default serving config: int8 ANN + pooled int8
        # prefilter + exact int8 rerank + device cache
        return MultiVectorIndex(
            FDEConfig(dimension=dim), device=device,
            ann_dtype="int8", rerank_dtype="int8", rerank_prefilter_pooling=4,
            device_cache_slots=256, device_cache_token_bucket=2048,
        )

    results = {}
    rankings = {}
    score_mats = {}
    for mode in ("bf16", "int8"):
        if mode == "int8":
            quantize_colqwen_params(model)
        emb = ColpaliEmbeddingModel(model, batch_size=settings.tpu.embed_batch_size,
                                    min_pixels=settings.model.min_pixels, max_pixels=settings.model.max_pixels,
                                    static_act_scales=settings.model.static_act_scales)
        t1 = time.time()
        page_embs = emb.embed_images(pages)
        q_embs = emb.embed_images(queries)
        embed_s = time.time() - t1
        index = production_index(cfg.embedding_dim)
        index.store(
            [np.asarray(e, np.float32) for e in page_embs],
            [IndexRecord(document_id=f"p{i}", chunk_number=0) for i in range(n_pages)],
        )
        ranked = []
        for qe in q_embs:
            hits = index.query(np.asarray(qe, np.float32), k=10)
            ranked.append([r.document_id for r, _ in hits])
        rankings[mode] = ranked
        # full exact-score matrix through the int8 rerank kernel (tie-robust
        # fidelity signal: Pearson over scores)
        d8, ds, dm = quantize_pool_int8([np.asarray(e, np.float32) for e in page_embs])
        score_mats[mode] = np.stack(
            [maxsim_scores_q8(np.asarray(qe, np.float32), d8, ds, dm, device=device).cpu().numpy()
             for qe in q_embs]
        )
        results[f"{mode}_embed_s"] = round(embed_s, 1)
        results[f"{mode}_self_recall_at_1"] = sum(
            1 for g, r in zip(gold, ranked) if r and r[0] == f"p{g}"
        ) / n_queries
        del emb, index

    top1, j1, j4, j10, taus = [], [], [], [], []
    for ra, rb in zip(rankings["bf16"], rankings["int8"]):
        top1.append(1.0 if (ra and rb and ra[0] == rb[0]) else 0.0)

        def jac(k):
            A, B = set(ra[:k]), set(rb[:k])
            return len(A & B) / max(len(A | B), 1)

        j1.append(jac(1)); j4.append(jac(4)); j10.append(jac(10))
        taus.append(kendall_tau(ra, rb))
    # per-query Pearson over the full exact-score vectors: robust to
    # near-tie tail-rank churn that makes jaccard/tau pessimistic on
    # random-feature corpora
    pearsons = []
    for qi in range(len(rankings["bf16"])):
        a_s, b_s = score_mats["bf16"][qi], score_mats["int8"][qi]
        a_c, b_c = a_s - a_s.mean(), b_s - b_s.mean()
        denom = np.linalg.norm(a_c) * np.linalg.norm(b_c)
        pearsons.append(float(a_c @ b_c / denom) if denom > 0 else 1.0)
    # result-set composition, margin-aware: an int8 top-10 member counts
    # as a real substitution only when its bf16 exact score falls below
    # bf16's 10th-best by more than 2x that query's quantization noise
    # floor (median |bf16 - int8| score deviation)
    margin_agreements, recall_vs_bf16 = [], []
    for qi, (ra, rb) in enumerate(zip(rankings["bf16"], rankings["int8"])):
        a_s, b_s = score_mats["bf16"][qi], score_mats["int8"][qi]
        tie_eps = float(np.median(np.abs(a_s - b_s)))
        thresh10 = float(np.sort(a_s)[-min(10, len(a_s))])
        int8_rows = [int(doc[1:]) for doc in rb[:10]]  # "p{i}" -> i
        ok = [1.0 if a_s[r] >= thresh10 - 2.0 * tie_eps else 0.0 for r in int8_rows]
        margin_agreements.append(sum(ok) / max(len(ok), 1))
        recall_vs_bf16.append(len(set(ra[:10]) & set(rb[:10])) / max(len(ra[:10]), 1))
    n = max(len(top1), 1)
    results.update(
        geometry="tiny" if small else "3b",
        n_pages=n_pages, n_queries=n_queries,
        top1_match=sum(top1) / n,
        jaccard_at_1=sum(j1) / n, jaccard_at_4=sum(j4) / n, jaccard_at_10=sum(j10) / n,
        kendall_tau_top10=sum(taus) / n,
        score_pearson=sum(pearsons) / n,
        recall_vs_bf16_at_10=sum(recall_vs_bf16) / n,
        top10_margin_agreement=sum(margin_agreements) / n,
        total_s=round(time.time() - t0, 1),
    )
    return results, rankings, score_mats


def part_a_ranking_agreement(small: bool, device=None, model=None, counts=None) -> dict:
    return _part_a(small, device, model, counts)[0]


POOLS = (75, 150, 300)


def _part_b(small: bool, device=None):
    """-> (report, exact score matrix (Q, n_docs)) of Part B."""
    import torch

    from morphik_core_tpu_torch.ops.fde import FDEConfig, fde_document_batch, fde_query
    from morphik_core_tpu_torch.parallel.search import int8_matvec, quantize_vec_int8, topk_stable

    device = _device(device)
    cfg = FDEConfig()
    n_docs, n_tok, n_queries = (2_000, 32, 8) if small else (100_000, 32, 16)
    n_relevant = 10  # planted relevant docs per query
    n_qtok = 8
    d = cfg.dimension
    rng = np.random.default_rng(0)
    t0 = time.time()

    # clustered corpus (tests/test_fde.py's generator scaled up): 512 unit
    # concepts; each doc draws tokens from its own 4-topic subset, and each
    # query plants a cluster of `n_relevant` docs sharing its topic set
    n_concepts = 512
    concepts = rng.standard_normal((n_concepts, d)).astype(np.float32)
    concepts /= np.linalg.norm(concepts, axis=1, keepdims=True)
    doc_topics = rng.random((n_docs, n_concepts)).argsort(axis=1)[:, :4].astype(np.int32)
    q_topics = np.stack([rng.choice(n_concepts, 4, replace=False) for _ in range(n_queries)])
    for qi in range(n_queries):
        doc_topics[qi * n_relevant : (qi + 1) * n_relevant] = q_topics[qi]
    ids = doc_topics[np.arange(n_docs)[:, None], rng.integers(0, 4, (n_docs, n_tok))]
    docs = concepts[ids] + 0.15 * rng.standard_normal((n_docs, n_tok, d)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=2, keepdims=True)

    queries = []
    for qi in range(n_queries):
        qids = q_topics[qi][rng.integers(0, 4, n_qtok)]
        q = concepts[qids] + 0.15 * rng.standard_normal((n_qtok, d)).astype(np.float32)
        queries.append(q / np.linalg.norm(q, axis=1, keepdims=True))

    # one upload a doc chunk: exact chamfer (all queries at once, f32 with
    # TF32 off), the FDE encode and the int8 row quantization on the device
    q_stack = torch.from_numpy(np.stack(queries)).to(device)  # (Q, n_qtok, d)
    chunk = 8_192
    exact = np.zeros((n_queries, n_docs), np.float32)
    q8_chunks, scale_chunks, f32_chunks = [], [], []
    for lo in range(0, n_docs, chunk):
        dchunk = torch.from_numpy(docs[lo : lo + chunk]).to(device)
        sim = torch.einsum("Qqd,cnd->Qcqn", q_stack, dchunk)
        exact[:, lo : lo + dchunk.shape[0]] = sim.amax(dim=-1).sum(dim=-1).cpu().numpy()
        rows = fde_document_batch(dchunk, torch.ones(dchunk.shape[:2], device=device), cfg)
        s = torch.clamp(rows.abs().amax(dim=-1) / 127.0, min=1e-12)
        q8_chunks.append(torch.clamp(torch.round(rows / s[:, None]), -127, 127).to(torch.int8))
        scale_chunks.append(s.float())
        f32_chunks.append(rows)
        del sim, dchunk
    q8_dev = torch.cat(q8_chunks)
    scales_dev = torch.cat(scale_chunks)
    f32_dev = torch.cat(f32_chunks)  # unquantized FDE control index
    del q8_chunks, scale_chunks, f32_chunks
    exact_s = time.time() - t0
    encode_s = 0.0  # fused into the chunk pass above

    rec = {f"{kind}@{p}": [] for kind in ("q8_top10", "f32_top10", "q8_rel", "f32_rel") for p in POOLS}
    recalls_1 = []
    for qi, q in enumerate(queries):
        qe = fde_query(torch.from_numpy(q).to(device), cfg)
        qq, qs = quantize_vec_int8(qe)
        scores = int8_matvec(q8_dev, qq).float() * scales_dev * qs
        pool_q8 = topk_stable(scores, max(POOLS))[1].cpu().numpy()
        pool_f32 = topk_stable(f32_dev @ qe, max(POOLS))[1].cpu().numpy()
        ex_top10 = set(np.argsort(-exact[qi])[:10].tolist())
        rel = set(range(qi * n_relevant, (qi + 1) * n_relevant))
        for p in POOLS:
            sq, sf = set(pool_q8[:p].tolist()), set(pool_f32[:p].tolist())
            rec[f"q8_top10@{p}"].append(len(ex_top10 & sq) / 10)
            rec[f"f32_top10@{p}"].append(len(ex_top10 & sf) / 10)
            rec[f"q8_rel@{p}"].append(len(rel & sq) / n_relevant)
            rec[f"f32_rel@{p}"].append(len(rel & sf) / n_relevant)
        recalls_1.append(1.0 if int(np.argmax(exact[qi])) in set(pool_q8[:75].tolist()) else 0.0)
    means = {k: float(np.mean(v)) for k, v in rec.items()}
    report = {
        "n_docs": n_docs, "n_tokens_per_doc": n_tok, "n_queries": n_queries,
        "n_relevant_per_query": n_relevant,
        "fde_dim": cfg.fde_dim, "index_quantization": "int8 per-row",
        # the int8-vs-f32 delta is the gate's signal (both indexes share the
        # FDE transform; the absolute recall is the prefilter's own)
        "recall_at_75_of_exact_top10": means["q8_top10@75"],
        "recall_at_75_of_exact_top10_f32_index": means["f32_top10@75"],
        "int8_recall_delta_at_75": means["q8_top10@75"] - means["f32_top10@75"],
        "recall_at_75_of_exact_top1": float(np.mean(recalls_1)),
        "recall_at_75_of_planted_relevant": means["q8_rel@75"],
        "pool_scaling": {
            str(p): {"exact_top10_q8": means[f"q8_top10@{p}"],
                     "exact_top10_f32": means[f"f32_top10@{p}"],
                     "planted_relevant_q8": means[f"q8_rel@{p}"]}
            for p in POOLS
        },
        "exact_groundtruth_s": round(exact_s, 1),
        "fde_encode_s": round(encode_s, 1),
    }
    return report, exact


def part_b_fde_recall_at_scale(small: bool, device=None) -> dict:
    return _part_b(small, device)[0]


# The stated acceptance gate for int8 serving (the original's, unchanged):
# every criterion must hold on the 3B geometry run. top1_match = the served
# answer is the same; score_pearson = exact-rerank score fidelity;
# top10_margin_agreement = result-set composition, counting only genuinely
# worse substitutions; int8_recall_delta = the int8 index must not lose
# more than 2 points of pool recall against the same FDE rows in f32.
GATE = {
    "top1_match": 0.90,
    "score_pearson": 0.98,
    "top10_margin_agreement": 0.90,
    "int8_recall_delta_at_75": -0.02,
}


def gate_verdict(report: dict) -> bool:
    a = report.get("part_a_ranking_agreement")
    b = report.get("part_b_fde_recall_at_scale")
    ok = bool(a) and (
        a["top1_match"] >= GATE["top1_match"]
        and a["score_pearson"] >= GATE["score_pearson"]
        # older partial reports (--merge) may predate the composition
        # metric; the gate only passes when it is present and green
        and a.get("top10_margin_agreement", -1.0) >= GATE["top10_margin_agreement"]
    )
    if b is not None:
        ok = ok and b["int8_recall_delta_at_75"] >= GATE["int8_recall_delta_at_75"]
    return bool(ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--skip-part-b", action="store_true")
    ap.add_argument("--skip-part-a", action="store_true")
    ap.add_argument("--merge", type=Path, default=None,
                    help="start from a previous partial report (rerun one part)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    report = json.loads(args.merge.read_text()) if args.merge else {}

    def checkpoint():  # partial results survive an interrupted run
        if args.out:
            args.out.write_text(json.dumps(report, indent=1))

    if not args.skip_part_a:
        report["part_a_ranking_agreement"] = part_a_ranking_agreement(args.small, device)
        checkpoint()
    if not args.skip_part_b:
        report["part_b_fde_recall_at_scale"] = part_b_fde_recall_at_scale(args.small, device)
        checkpoint()
    gate_ok = gate_verdict(report)
    report["gate"] = {"thresholds": GATE, "int8_default_approved": gate_ok}
    print(json.dumps(report))
    if args.out:
        args.out.write_text(json.dumps(report, indent=1))
    return 0 if gate_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
