#!/usr/bin/env python3
"""ColPali visual-retrieval evaluation through the port's full stack:
twin of `evaluations/colpali_eval.py`, with its corpus, perturbation
ladder, flags and report keys.

It ingests a generated multi-page PDF corpus with `use_colpali=true`
(PDF parse -> page raster -> preprocess -> vision tower (K3) -> FDE ->
int8 ANN -> pooled prefilter -> exact MaxSim rerank (K1)), then runs
page-level retrieval with image queries and reports recall@{1,4,10} and
MRR per query set, gold labels being (document, page) pairs:
- "visual:<rung>": perturbed copies of a gold page's stored payload
  (blur, noise, JPEG recompression, rescale, occlusion, and "wreck", all
  of them at once). They measure the pipeline's structural fidelity and
  work with any weights.
- keyword images, keyword pages and text queries of the fact planted on
  each page: near chance with random weights, semantic metrics with the
  trained fixture or a checkpoint.

The perturbations are Pillow's, in numpy and pixel for pixel:
`pil_default.gaussian_blur` (`ImageFilter.GaussianBlur`),
`resize_bicubic_u8` (`Image.resize`'s default), the port's JPEG codec (a
save and reopen), `pil_default.draw_text` (`ImageDraw.text` in the
default font). Stored payloads are decoded by the port's decoders and
queries travel as PNGs (`utils/png.py`).

One divergence: `serving_precision` names what the model serves. The
original reports `model.matmul_precision` from the settings ("int8")
also for the fixture geometry, whose model it serves in f32.

Usage:
    python -m morphik_core_tpu_torch.evaluations.colpali_eval [--docs 55] [--pages 8]
        [--queries 40] [--templates 11] [--small] [--skip-ladder]
        [--geometry dev|3b|fixture] [--fixture NPZ] [--checkpoint DIR] [--out EVAL.json] [--cpu]

It runs on the card, or on the CPU with `--cpu`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import tempfile
import time
import zlib
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from morphik_core_tpu_torch.evaluations.pil_default import draw_text, gaussian_blur

VOCAB = (
    "alpha bridge casing dynamo ember flux gasket helix ion joule kelvin lumen "
    "motor nacelle orbit piston quartz rotor stator torque valve winding yoke zenith"
).split()


def make_pdf(pages_text: List[str]) -> bytes:
    """Minimal multi-page PDF with FlateDecode text content streams
    (same construction the parser tests use)."""
    objs = []
    kids = " ".join(f"{3 + 2 * i} 0 R" for i in range(len(pages_text)))
    objs.append(b"1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n")
    objs.append(f"2 0 obj<</Type/Pages/Kids[{kids}]/Count {len(pages_text)}>>endobj\n".encode())
    for i, text in enumerate(pages_text):
        page_num, content_num = 3 + 2 * i, 4 + 2 * i
        objs.append(
            f"{page_num} 0 obj<</Type/Page/Parent 2 0 R/MediaBox[0 0 612 792]"
            f"/Contents {content_num} 0 R>>endobj\n".encode()
        )
        ops = b"BT /F1 12 Tf 72 720 Td "
        for j, line in enumerate(text.split("\n")):
            esc = line.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
            if j:
                ops += b"0 -14 Td "
            ops += b"(" + esc.encode("latin-1", "replace") + b") Tj "
        ops += b"ET"
        comp = zlib.compress(ops)
        objs.append(
            f"{content_num} 0 obj<</Length {len(comp)}/Filter/FlateDecode>>stream\n".encode()
            + comp + b"\nendstream endobj\n"
        )
    return b"%PDF-1.4\n" + b"".join(objs) + b"trailer<</Root 1 0 R>>\n%%EOF"


def gen_corpus(n_docs: int, pages_per_doc: int, seed: int = 0, n_templates: int = 0):
    """Returns (pdfs, facts): pdfs = [(filename, bytes)], facts = list of
    {doc, page, keyword, question, answer}, one planted fact a page.

    `n_templates` > 0 makes the corpus distractor-heavy: docs are drawn
    from a small pool of shared page layouts (same filler lines, same
    fact-slot position), so every gold page has n_docs/n_templates
    near-duplicate siblings differing only in the keyword/value glyphs."""
    rng = np.random.default_rng(seed)
    templates = []
    for _ in range(max(n_templates, 1)):
        filler = [" ".join(rng.choice(VOCAB, rng.integers(3, 9)).tolist())
                  for _ in range(int(rng.integers(10, 16)))]
        templates.append((filler, int(rng.integers(2, len(filler)))))
    pdfs, facts = [], []
    for d in range(n_docs):
        pages = []
        for p in range(pages_per_doc):
            kw = f"{rng.choice(VOCAB).upper()}-{rng.integers(1000, 9999)}"
            val = int(rng.integers(10, 990))
            if n_templates:
                filler, slot = templates[(d * pages_per_doc + p) % n_templates]
                lines = [f"UNIT SPEC {kw}", ""] + list(filler)
                lines.insert(slot, f"rated torque of {kw} is {val} Nm")
            else:
                lines = [f"UNIT SPEC {kw}", ""]
                for _ in range(int(rng.integers(8, 16))):
                    lines.append(" ".join(rng.choice(VOCAB, rng.integers(3, 9)).tolist()))
                lines.insert(int(rng.integers(2, len(lines))), f"rated torque of {kw} is {val} Nm")
            pages.append("\n".join(lines))
            facts.append(
                {
                    "doc": f"spec_{d:03d}.pdf", "page": p, "keyword": kw,
                    "question": f"What is the rated torque of {kw}?",
                    "answer": f"{val} Nm",
                }
            )
        pdfs.append((f"spec_{d:03d}.pdf", make_pdf(pages)))
    return pdfs, facts


# --------------------------------------------------------- perturbations

def _to_img(arr) -> np.ndarray:
    return np.clip(arr, 0, 255).astype(np.uint8)


def _jpeg_round_trip(pixels: np.ndarray, quality: int) -> np.ndarray:
    """A JPEG save at `quality` and a reopen, as Pillow's."""
    from morphik_core_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

    return decode_jpeg(encode_jpeg(pixels, quality=quality)[0])


def _rescaled(img: np.ndarray, f: int) -> np.ndarray:
    """`img.resize((w // f, h // f)).resize((w, h))`, bicubic both ways."""
    from morphik_core_tpu_torch.models.colqwen.preprocess import resize_bicubic_u8

    h, w = img.shape[:2]
    return resize_bicubic_u8(resize_bicubic_u8(img, (max(1, h // f), max(1, w // f))), (h, w))


def _occlude(a, frac, rng):
    """White rectangles until ~`frac` of the page area is covered."""
    h, w, _ = a.shape
    covered = np.zeros((h, w), bool)
    while covered.mean() < frac:
        bh, bw = int(h * 0.18), int(w * 0.18)
        y, x = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
        a[y : y + bh, x : x + bw] = 255.0
        covered[y : y + bh, x : x + bw] = True
    return a


def perturb(img: np.ndarray, rung: str, rng) -> np.ndarray:
    """Full-page perturbations of an (H, W, 3) uint8 page (extent kept:
    ColPali patch grids are position-sensitive, so difficulty comes from
    pixel damage, not crops). Parameterized rungs: "blur:S", "occ:F",
    "jpeg:Q", "rescale:F", "noise:S"."""
    a = img.astype(np.float32)
    kind, *ps = rung.split(":")
    if kind == "identity":
        return img
    if kind == "blur":
        return gaussian_blur(img, float(ps[0]))
    if kind == "noise":
        return _to_img(a + rng.normal(0, float(ps[0]), a.shape))
    if kind == "jpeg":
        return _jpeg_round_trip(_to_img(a + rng.normal(0, 10, a.shape)), int(ps[0]))
    if kind == "rescale":
        return _rescaled(img, int(ps[0]))
    if kind == "occ":
        a = _occlude(a.copy(), float(ps[0]), rng)
        return _to_img(a + rng.normal(0, 15, a.shape))
    if kind == "wreck":
        # compound damage: the deliberately-unsaturated top rung
        h, w = img.shape[:2]
        a2 = _rescaled(img, 5).astype(np.float32)
        for _ in range(8):
            y, x = int(rng.integers(0, h * 3 // 4)), int(rng.integers(0, w * 3 // 4))
            a2[y : y + h // 4, x : x + w // 4] = 255.0
        return _jpeg_round_trip(_to_img(a2 + rng.normal(0, 30, a2.shape)), 15)
    raise ValueError(rung)


# easy -> hard; identity pins the sanity row near the top, wreck stays near
# the floor. Recall calibration of the TPU rounds (the original's, on the
# trained fixture at 440 distractor-heavy pages, round 4): identity 0.90,
# jpeg:4 0.50; blur 1/1.5/2 = 0.18/0.05/0.03, occ 0.45/0.65 = 0.13/0.03,
# rescale:5 = 0.0. The sweep below shifts every floored family one notch
# lighter so most rungs sit in recall@1 (0.2, 0.9) and can regress.
RUNGS = (
    "identity", "blur:0.5", "blur:1", "jpeg:4",
    "rescale:2", "rescale:3", "occ:0.25", "occ:0.45", "wreck",
)
RUNGS_SMALL = ("identity", "blur:1", "occ:0.45")


def render_keyword(kw: str) -> np.ndarray:
    """The 280 x 40 keyword query: "rated torque of KW" in the default font."""
    page = np.full((40, 280), 255, np.uint8)
    draw_text(page, (8, 12), f"rated torque of {kw}")
    return np.repeat(page[..., None], 3, axis=2)


def render_keyword_page(kw: str) -> np.ndarray:
    """Page-geometry keyword query: the text-page raster of only the fact
    lines (same scale and positions as gold pages, none of the filler)."""
    from morphik_core_tpu_torch.parser.text_render import render_text_page

    return render_text_page(f"UNIT SPEC {kw}\n\nrated torque of {kw}", dpi=150)


# --------------------------------------------------------------- harness

def _model(args, settings, device):
    """The geometry's model (None: development mode's tiny random one)."""
    import torch

    from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel, quantize_colqwen_params

    if args.checkpoint:
        # real ColQwen2.5 weights: keyword/text rows become the
        # reference-comparable semantic metrics
        settings.model.checkpoint_path = str(args.checkpoint)
        return ColQwenModel.from_checkpoint(args.checkpoint, device=device,
                                            matmul_precision=settings.model.matmul_precision)
    if args.geometry == "fixture":
        # the committed tiny trained checkpoint, served in f32 as the
        # original serves it
        model = ColQwenModel.from_fixture(args.fixture, device=device)
        settings.model.matmul_precision = model.matmul_precision
        return model
    if args.geometry == "3b":
        # full 3B geometry, random bf16 weights at the configured precision
        model = ColQwenModel.init_random(ColQwenConfig(), seed=0, device=device, dtype=torch.bfloat16)
        if settings.model.matmul_precision == "int8":
            quantize_colqwen_params(model)
        return model
    return None


def _serving_precision(model) -> str:
    if model.matmul_precision == "int8":
        return "int8"
    return {"torch.float32": "f32", "torch.bfloat16": "bf16"}.get(str(model.dtype), str(model.dtype))


async def run_eval(args, device=None) -> Dict:
    """`device`: the services' (the card unless the caller passes "cpu")."""
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.models.schemas import AuthContext, EntityType
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri, data_uri_to_bytes
    from morphik_core_tpu_torch.utils.image import decode_image
    from morphik_core_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(1)
    pdfs, facts = gen_corpus(args.docs, args.pages, seed=0, n_templates=args.templates)
    n_pages_total = args.docs * args.pages
    rungs = RUNGS_SMALL if args.small else RUNGS

    with tempfile.TemporaryDirectory() as tmp:
        settings = Settings.from_dict(
            {
                "storage": {"storage_path": f"{tmp}/storage"},
                "database": {"path": f"{tmp}/db.sqlite"},
                "vector_store": {"index_path": f"{tmp}/index"},
                "telemetry": {"telemetry_dir": f"{tmp}/telemetry"},
            }
        )
        colqwen_model = _model(args, settings, device)
        services = build_services(settings, colqwen_model=colqwen_model, device=device)
        try:
            await services.database.initialize()
            auth = AuthContext(
                entity_type=EntityType.DEVELOPER, entity_id="eval",
                permissions={"read", "write", "admin"}, user_id="eval",
            )

            t0 = time.time()
            name_to_id: Dict[str, str] = {}
            for fname, data in pdfs:
                doc = await services.ingestion_service.ingest_file_content(
                    data, fname, {}, auth, use_colpali=True
                )
                await services.ingestion_service.process_ingestion_job(
                    doc.external_id, auth, use_colpali=True
                )
                name_to_id[fname] = doc.external_id
            ingest_s = time.time() - t0

            # page images as stored (the store's own payloads are the honest
            # source for perturbation queries), each decoded once
            decoded: Dict[Tuple[str, int], np.ndarray] = {}

            async def page_image(doc_name: str, page: int) -> np.ndarray:
                if (doc_name, page) not in decoded:
                    chunks = await services.document_service.batch_retrieve_chunks(
                        [(name_to_id[doc_name], page)], auth, use_colpali=True
                    )
                    assert chunks and chunks[0].metadata.get("is_image"), f"no page image {doc_name}:{page}"
                    decoded[(doc_name, page)] = decode_image(data_uri_to_bytes(chunks[0].content))
                return decoded[(doc_name, page)]

            async def retrieve_image(img: np.ndarray) -> List[Tuple[str, int]]:
                chunks = await services.document_service.retrieve_chunks(
                    "", auth, k=10, use_colpali=True,
                    query_image=bytes_to_data_uri(encode_png(img), "image/png"),
                )
                return [(c.document_id, c.chunk_number) for c in chunks]

            def metrics(ranks: List[int | None], n: int) -> Dict:
                return {
                    "n": n,
                    "recall_at_1": sum(1 for r in ranks if r and r <= 1) / n,
                    "recall_at_4": sum(1 for r in ranks if r and r <= 4) / n,
                    "recall_at_10": sum(1 for r in ranks if r and r <= 10) / n,
                    "mrr": sum(1.0 / r for r in ranks if r) / n,
                }

            # ---- visual perturbation ladder (page-level gold) ----
            probe_facts = [facts[i] for i in rng.choice(len(facts), min(args.queries, len(facts)), replace=False)]
            by_rung = {}
            t0 = time.time()
            if args.skip_ladder:
                rungs = ()
            for rung in rungs:
                ranks = []
                for f in probe_facts:
                    img = await page_image(f["doc"], f["page"])
                    got = await retrieve_image(perturb(img, rung, rng))
                    gold = (name_to_id[f["doc"]], f["page"])
                    ranks.append(next((i + 1 for i, g in enumerate(got) if g == gold), None))
                by_rung[rung] = metrics(ranks, len(probe_facts))
            visual_s = time.time() - t0

            # ---- keyword-image + text queries over all probe facts ----
            kw_ranks, kwp_ranks, txt_ranks = [], [], []
            for f in probe_facts:
                gold = (name_to_id[f["doc"]], f["page"])
                got = await retrieve_image(render_keyword(f["keyword"]))
                kw_ranks.append(next((i + 1 for i, g in enumerate(got) if g == gold), None))
                got = await retrieve_image(render_keyword_page(f["keyword"]))
                kwp_ranks.append(next((i + 1 for i, g in enumerate(got) if g == gold), None))
                chunks = await services.document_service.retrieve_chunks(
                    f["question"], auth, k=10, use_colpali=True
                )
                got = [(c.document_id, c.chunk_number) for c in chunks]
                txt_ranks.append(next((i + 1 for i, g in enumerate(got) if g == gold), None))
            served = services.colpali_embedding_model.model
        finally:
            services.ingestion_service.raster_pool.shutdown()
            if services.colpali_vector_store is not None:
                services.colpali_vector_store.close()

        checkpoint = settings.model.checkpoint_path
        if not checkpoint and args.geometry == "fixture":
            checkpoint = f"trained tiny fixture ({args.fixture.name})"
        return {
            "corpus": {"docs": args.docs, "pages_per_doc": args.pages,
                       "total_pages": n_pages_total, "templates": args.templates,
                       "ingest_s": round(ingest_s, 1)},
            "geometry": args.geometry,
            "serving_precision": _serving_precision(served),
            "weights": checkpoint or "random (no checkpoint in env — structural fidelity mode)",
            "gold_granularity": "(document, page)",
            "visual_ladder": by_rung,
            "visual_ladder_s": round(visual_s, 1),
            "keyword_image_queries": metrics(kw_ranks, len(kw_ranks)),
            "keyword_page_queries": metrics(kwp_ranks, len(kwp_ranks)),
            "text_queries": metrics(txt_ranks, len(txt_ranks)),
            "chance_recall_at_10": round(10 / n_pages_total, 4),
        }


DEFAULT_FIXTURE = Path(__file__).resolve().parents[2] / "tests/fixtures/tiny_colqwen.npz"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=55)
    ap.add_argument("--pages", type=int, default=8)
    ap.add_argument("--queries", type=int, default=40)
    ap.add_argument("--templates", type=int, default=11,
                    help="page-layout templates shared across docs (0 = every page unique)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--small", action="store_true", help="smoke run: tiny corpus + 3-rung ladder")
    ap.add_argument("--skip-ladder", action="store_true",
                    help="keyword/text rows only (semantic-row focus runs)")
    ap.add_argument("--geometry", choices=("dev", "3b", "fixture"),
                    default="fixture" if DEFAULT_FIXTURE.exists() else "dev",
                    help="dev = tiny random tower; 3b = full geometry, random "
                         "weights; fixture = committed tiny trained checkpoint")
    ap.add_argument("--fixture", type=Path, default=DEFAULT_FIXTURE)
    ap.add_argument("--checkpoint", type=Path, default=None,
                    help="local HF-format ColQwen2.5 dir; overrides --geometry with real weights")
    args = ap.parse_args(argv)
    if args.small:
        args.docs, args.pages, args.queries, args.templates = 5, 4, 8, 2
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    out = asyncio.run(run_eval(args, device="cpu" if args.cpu else None))
    print(json.dumps(out))
    if args.out:
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
