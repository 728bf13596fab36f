"""The port's evaluation harnesses (`morphik_core_tpu_torch/evaluations/`)
against the originals in `evaluations/`, on the CPU.

- Pillow in numpy: `pil_default.draw_text` (the default font, through the
  committed atlas, which a test regenerates equal) and `gaussian_blur`
  pixel for pixel with Pillow; every rung of the ladder and the fidelity
  queries' `perturbed` equal to the originals' on the same rng; the
  generated PDFs byte for byte.
- fidelity_eval Part A at the tiny geometry, the JAX random weights carried
  into the port with `load_jax_params`: the same top-1 ids and self-recall
  in bf16 and int8. The score matrices differ by what the two bf16 towers'
  rounding does to the embeddings (measured up to 0.3 of scores near 30;
  the bound is 2% of the score), and the port's K1 path scores the
  reference's own embeddings within f32 rounding (rtol 1e-5, atol 1e-4).
  Part B at its small size: the same report (timings aside) and the exact
  chamfer matrix within 1e-5.
- colpali_eval's `run_eval` at the fixture geometry on a small corpus of
  unique pages: the report equal to the JAX one, durations aside, and
  `serving_precision` (the original names the settings' "int8" while it
  serves the fixture in f32; the twin names what it serves). Pages of a
  shared template score within ~1e-4 of each other, and the int8 rerank
  turns f32 round-off into score moves of ~0.1 of 750, so near-duplicate
  pages may swap between any two implementations: the parity run uses
  unique pages.
- run_offline_eval over the builtin corpus and `evaluations/benchmark/`:
  equal reports (latency aside); the LLM judge against the local fake
  provider: the same verdicts and requests; the HotpotQA adapter: the
  same files.
"""

import asyncio
import io
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from PIL import Image, ImageDraw, ImageFilter

from evaluations import colpali_eval as jc, fidelity_eval as jf, hotpot_adapter as jh
from evaluations import judge as jjudge, run_offline_eval as jo
from morphik_core_tpu_torch.evaluations import colpali_eval as tc, fidelity_eval as tf, hotpot_adapter as th
from morphik_core_tpu_torch.evaluations import judge as tjudge, pil_default, run_offline_eval as to
from morphik_core_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ Pillow in numpy


@pytest.mark.parametrize("seed", [0, 3, 11, 29])
def test_render_page_is_pixel_equal_to_pil(seed):
    assert np.array_equal(tf.render_page(seed), np.asarray(jf.render_page(seed)))


def test_render_keyword_is_pixel_equal_to_pil():
    _, facts = jc.gen_corpus(6, 4, seed=0, n_templates=2)
    for f in facts:
        img = Image.new("RGB", (280, 40), "white")
        ImageDraw.Draw(img).text((8, 12), f"rated torque of {f['keyword']}", fill="black")
        assert np.array_equal(tc.render_keyword(f["keyword"]), np.asarray(img)), f["keyword"]


def test_default_font_atlas_regenerates_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(pil_default.load_default_font, "cache_clear", lambda: None)
    fresh = pil_default.write_default_font_atlas(tmp_path / "atlas.npz")
    with np.load(pil_default.ATLAS_PATH) as a, np.load(fresh) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
        assert b["kern"].size == 0  # BASIC layout: no kerning among the atlas's characters


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48), rgb=st.booleans(),
       radius=st.sampled_from([0.5, 1, 1.5, 2, 3]), seed=st.integers(0, 2**31 - 1))
def test_gaussian_blur_is_bit_identical_to_pillow(h, w, rgb, radius, seed):
    shape = (h | 1, w | 1, 3) if rgb else (h | 1, w | 1)  # odd sizes
    x = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(Image.fromarray(x).filter(ImageFilter.GaussianBlur(radius)))
    assert np.array_equal(pil_default.gaussian_blur(x, radius), want)


def _stored_page():
    """A stored page as the ladder sees it: a text page's q70 payload,
    decoded."""
    from morphik_core_tpu_torch.parser.text_render import render_text_page

    page = render_text_page("UNIT SPEC ROTOR-4242\n\nrated torque of ROTOR-4242 is 17 Nm\nhelix ion joule lumen", 150)
    data = encode_jpeg(page, 70)[0]
    return Image.open(io.BytesIO(data)).convert("RGB"), decode_jpeg(data)


@pytest.mark.parametrize("rung", list(jc.RUNGS) + ["noise:20", "blur:1.5", "blur:2", "jpeg:30", "occ:0.65",
                                                   "rescale:5"])
def test_rung_is_pixel_equal_to_the_original(rung):
    pil, arr = _stored_page()
    assert np.array_equal(np.asarray(pil), arr)
    r_j, r_t = np.random.default_rng(5), np.random.default_rng(5)
    assert np.array_equal(tc.perturb(arr, rung, r_t), np.asarray(jc.perturb(pil, rung, r_j)))
    assert r_j.integers(1 << 30) == r_t.integers(1 << 30)  # the same draws


@pytest.mark.parametrize("seed", [1000, 1003])
def test_perturbed_is_pixel_equal_to_the_original(seed):
    page = jf.render_page(seed - 1000)
    assert np.array_equal(tf.perturbed(np.asarray(page), seed), np.asarray(jf.perturbed(page, seed)))


@pytest.mark.parametrize("templates", [0, 11])
def test_gen_corpus_pdfs_are_byte_identical(templates):
    assert tc.gen_corpus(4, 3, seed=0, n_templates=templates) == jc.gen_corpus(4, 3, seed=0, n_templates=templates)
    assert tc.make_pdf(["a (b) \\ c", ""]) == jc.make_pdf(["a (b) \\ c", ""])


def test_kendall_tau_matches():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = [f"p{i}" for i in rng.permutation(12)[:10]]
        b = [f"p{i}" for i in rng.permutation(12)[:10]]
        assert tf.kendall_tau(a, b) == jf.kendall_tau(a, b)


# ------------------------------------------------------------ fidelity_eval


class _NumpySpy(types.ModuleType):
    """numpy for the original's module, recording `argmax` arguments (Part
    B's exact scores)."""

    def __init__(self):
        super().__init__("numpy_spy")
        self.seen = []

    def __getattr__(self, name):
        return getattr(np, name)

    def argmax(self, a, *args, **kwargs):
        self.seen.append(np.array(a))
        return np.argmax(a, *args, **kwargs)


def test_part_a_tiny_geometry_against_jax(monkeypatch):
    import jax
    import jax.numpy as jnp

    from morphik_core_tpu.embedding.colpali_embedding_model import ColpaliEmbeddingModel as JEmb
    from morphik_core_tpu.index.multivector_index import MultiVectorIndex as JIndex
    from morphik_core_tpu.models.colqwen.config import ColQwenConfig as JConfig
    from morphik_core_tpu.models.colqwen.model import init_colqwen_params
    from morphik_core_tpu.ops import maxsim as jmaxsim
    from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel, load_jax_params
    from morphik_core_tpu_torch.ops.maxsim import maxsim_scores_q8, quantize_pool_int8

    ranked, mats, embs = [], [], []
    j_query, j_scores, j_embed = JIndex.query, jmaxsim.maxsim_scores_q8, JEmb.embed_images

    def query(self, q, *args, **kwargs):
        hits = j_query(self, q, *args, **kwargs)
        ranked.append([r.document_id for r, _ in hits])
        return hits

    def scores(*args, **kwargs):
        out = j_scores(*args, **kwargs)
        mats.append(np.asarray(out))
        return out

    def embed(self, images, *args, **kwargs):
        out = j_embed(self, images, *args, **kwargs)
        embs.append([np.asarray(e, np.float32) for e in out])
        return out

    monkeypatch.setattr(JIndex, "query", query)
    monkeypatch.setattr(jmaxsim, "maxsim_scores_q8", scores)
    monkeypatch.setattr(JEmb, "embed_images", embed)
    j_report = jf.part_a_ranking_agreement(True)

    params = jax.jit(lambda k: init_colqwen_params(k, JConfig.tiny(), dtype=jnp.bfloat16))(jax.random.PRNGKey(0))
    model = ColQwenModel(ColQwenConfig.tiny(), device="cpu", dtype=torch.bfloat16)
    load_jax_params(model, jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(params)))
    t_report, t_rank, t_mats = tf._part_a(True, "cpu", model=model)

    assert sorted(t_report) == sorted(j_report)
    for key in ("bf16_self_recall_at_1", "int8_self_recall_at_1", "top1_match", "geometry", "n_pages", "n_queries"):
        assert t_report[key] == j_report[key], key
    for mode, (lo, hi) in (("bf16", (0, 8)), ("int8", (8, 16))):
        assert [r[0] for r in t_rank[mode]] == [r[0] for r in ranked[lo:hi]], mode
        want = np.stack(mats[lo:hi])
        np.testing.assert_allclose(t_mats[mode], want, rtol=2e-2, atol=0, err_msg=mode)
    # the port's K1 path over the reference's own embeddings: f32 rounding
    for (pages, queries), want in ((embs[0:2], np.stack(mats[0:8])), (embs[2:4], np.stack(mats[8:16]))):
        d8, ds, dm = quantize_pool_int8(pages)
        got = np.stack([maxsim_scores_q8(q, d8, ds, dm, device="cpu").numpy() for q in queries])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_part_b_small_against_jax(monkeypatch):
    spy = _NumpySpy()
    monkeypatch.setattr(jf, "np", spy)
    j_report = jf.part_b_fde_recall_at_scale(True)
    t_report, exact = tf._part_b(True, "cpu")
    drop = ("exact_groundtruth_s", "fde_encode_s")
    assert {k: v for k, v in t_report.items() if k not in drop} == {k: v for k, v in j_report.items() if k not in drop}
    np.testing.assert_allclose(exact, np.stack(spy.seen), rtol=0, atol=1e-5)


def test_fidelity_main_gate_matches_the_original(tmp_path, capsys):
    """`main` over a partial report (--merge, both parts skipped): the same
    report, gate and exit code for a passing and a failing report."""
    a = {"top1_match": 0.95, "score_pearson": 0.99, "top10_margin_agreement": 0.93}
    for part_a, part_b in ((a, {"int8_recall_delta_at_75": 0.0}), (dict(a, top1_match=0.5), None),
                           (a, {"int8_recall_delta_at_75": -0.05})):
        merge = tmp_path / "partial.json"
        merge.write_text(json.dumps({"part_a_ranking_agreement": part_a,
                                     **({"part_b_fde_recall_at_scale": part_b} if part_b else {})}))
        argv = ["--skip-part-a", "--skip-part-b", "--merge", str(merge)]
        rc_t = tf.main(argv)
        out_t = json.loads(capsys.readouterr().out)
        old = sys.argv
        sys.argv = ["fidelity_eval.py", *argv]
        try:
            rc_j = jf.main()
        finally:
            sys.argv = old
        assert (rc_t, out_t) == (rc_j, json.loads(capsys.readouterr().out))


# ------------------------------------------------------------ colpali_eval


def test_colpali_run_eval_fixture_against_jax():
    args = tc.parse_args(["--docs", "3", "--pages", "4", "--queries", "6", "--templates", "0"])
    args.small = True  # the three-rung ladder at this corpus
    t_out = asyncio.run(tc.run_eval(args, device="cpu"))
    j_out = asyncio.run(jc.run_eval(args))
    assert (t_out.pop("serving_precision"), j_out.pop("serving_precision")) == ("f32", "int8")
    for out in (t_out, j_out):
        out["corpus"].pop("ingest_s")
        out.pop("visual_ladder_s")
    assert t_out == j_out
    assert t_out["visual_ladder"]["identity"]["recall_at_1"] == 1.0


# ------------------------------------------------------- run_offline_eval


def _offline(module, corpus, questions, **kwargs):
    out = asyncio.run(module.run_eval(corpus, questions, False, **kwargs))
    out.pop("avg_latency_s")
    return out


def test_run_offline_eval_builtin_corpus_against_jax(tmp_path):
    for name, text in to.BUILTIN_CORPUS.items():
        (tmp_path / name).write_text(text)
    assert to.BUILTIN_QUESTIONS == jo.BUILTIN_QUESTIONS and to.BUILTIN_CORPUS == jo.BUILTIN_CORPUS
    t_out = _offline(to, tmp_path, to.BUILTIN_QUESTIONS, device="cpu")
    assert t_out == _offline(jo, tmp_path, jo.BUILTIN_QUESTIONS)
    assert t_out["recall_at_4"] == 1.0


def test_run_offline_eval_benchmark_against_jax():
    corpus = ROOT / "evaluations" / "benchmark" / "corpus"
    questions = json.loads((ROOT / "evaluations" / "benchmark" / "questions.json").read_text())
    t_out = _offline(to, corpus, questions, device="cpu")
    assert t_out == _offline(jo, corpus, questions)
    assert t_out["n_questions"] == len(questions)


def test_llm_judge_against_the_fake_provider():
    """Both judges against the local fake provider's chat endpoint: the
    same request bodies and verdicts (its answer carries no JSON, so both
    fall back to the substring match; a bad endpoint also falls back)."""
    from morphik_core_tpu_torch.scripts.fake_providers import ANSWER, FakeProviders

    fake = FakeProviders().start()
    try:
        cases = [("What grew?", "12%", ANSWER), ("What grew?", "15%", "revenue grew 12%")]
        verdicts = {}
        for name, mod in (("jax", jjudge), ("torch", tjudge)):
            fake.requests.clear()
            judge = mod.LLMJudge(fake.url, model="fake-judge", api_key="k")
            verdicts[name] = [asyncio.run(judge(*c)) for c in cases]
            verdicts[name + "_requests"] = [r["body"] for r in fake.requests]
            offline = mod.LLMJudge(None)
            verdicts[name + "_offline"] = [asyncio.run(offline(*c)) for c in cases]
        assert verdicts["jax"] == verdicts["torch"] == [True, False]
        assert verdicts["jax_requests"] == verdicts["torch_requests"] and len(verdicts["jax_requests"]) == 2
        assert verdicts["jax_offline"] == verdicts["torch_offline"]
    finally:
        fake.stop()


def test_build_judge_matches(monkeypatch):
    monkeypatch.delenv("MORPHIK_JUDGE_API_BASE", raising=False)
    args = types.SimpleNamespace(judge_api_base=None, judge_model=None, judge_api_key=None)
    assert to.build_judge(args)[1] == jo.build_judge(args)[1]
    args.judge_api_base = "http://127.0.0.1:9"
    assert to.build_judge(args)[1] == jo.build_judge(args)[1]


def test_hotpot_adapter_writes_the_same_files(tmp_path):
    rows = [{"question": f"q{i}?", "answer": f"a{i}",
             "supporting_facts": [[f"Title {i}", 0]],
             "context": [[f"Title {i}", [f"Sentence {i}."]], [f"Other {i % 2}", ["Filler."]]]} for i in range(4)]
    src = tmp_path / "hotpot.json"
    src.write_text(json.dumps(rows))
    out_j, out_t = tmp_path / "j", tmp_path / "t"
    assert th.convert(src, out_t, limit=3) == jh.convert(src, out_j, limit=3)
    files = lambda root: {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}
    assert files(out_t) == files(out_j)


def test_evals_import_nothing_of_the_reference():
    """No jax, no JAX package, no `evaluations` and no PIL (but the atlas
    writer, which runs only where PIL is); the run without them is
    tests/test_torch_jaxfree.py's."""
    for path in sorted((ROOT / "morphik_core_tpu_torch" / "evaluations").glob("*.py")):
        src = path.read_text().replace("morphik_core_tpu_torch", "")
        if path.name == "pil_default.py":
            writer = src.index("def write_default_font_atlas")
            src = src[:writer] + src[src.index("\n\n\n", writer):]
        for banned in ("import jax", "from jax", "morphik_core_tpu.", "from evaluations", "import evaluations",
                       "from PIL", "import PIL", "sys.path"):
            assert banned not in src, (path.name, banned)
