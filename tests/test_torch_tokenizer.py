"""The port's Qwen2 byte-level BPE tokenizer
(`morphik_core_tpu_torch/models/colqwen/tokenizer.py`) against the HF
`tokenizers` package, which the card's machine lacks.

Tolerance: none. Token ids equal `Tokenizer.encode(text,
add_special_tokens=False).ids`, and the scanner's pieces equal
`regex.findall` of the Qwen2 pattern.

The fixture `tests/fixtures/tokenizer_bpe.json` is a BPE trained with
`tokenizers` on seeded text in Qwen2.5's pipeline, with Qwen2.5's special
tokens at their ids 151643-151664 (also entries of `model.vocab`, as in
Qwen's file: without them the package splits `<|im_start|>` into bytes).
`tests/fixtures/tokenizer_cases.json` holds strings and the ids the
package gives; `chip_smoke.py` holds the port to them on the card's
machine. Both are written by `write_tokenizer_fixture()` (needs
`tokenizers`):

    python -c "import sys; sys.path[:0] = ['.', 'tests']; \\
        import test_torch_tokenizer as t; t.write_tokenizer_fixture()"
"""

import json
import unicodedata
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from morphik_core_tpu_torch.models.colqwen.tokenizer import QWEN2_PATTERN, QwenTokenizer, pre_tokenize

FIXTURES = Path(__file__).parent / "fixtures"
TOKENIZER_FIXTURE = FIXTURES / "tokenizer_bpe.json"
CASES_FIXTURE = FIXTURES / "tokenizer_cases.json"
VOCAB_SIZE = 3000

#: Qwen2.5's added tokens: (id, content, special)
QWEN_ADDED = [(151643 + i, tok, i < 14) for i, tok in enumerate((
    "<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>", "<|object_ref_end|>",
    "<|box_start|>", "<|box_end|>", "<|quad_start|>", "<|quad_end|>", "<|vision_start|>",
    "<|vision_end|>", "<|vision_pad|>", "<|image_pad|>", "<|video_pad|>", "<tool_call>", "</tool_call>",
    "<|fim_prefix|>", "<|fim_middle|>", "<|fim_suffix|>", "<|fim_pad|>", "<|repo_name|>", "<|file_sep|>"))]

#: strings held in the cases fixture: the model's prompt templates, each
#: whitespace class, contractions in mixed case, NFC-sensitive sequences
CASES = [
    "<|im_start|>user\n<|vision_start|>", "<|vision_end|>Describe the image.<|im_end|>\n", "<|endoftext|>",
    "Query: quarterly revenue growth", "Query: table of contents", "Query: signature page of the contract",
    "Query: figure 3: latency distribution", "I'm sure they'll say it's what we've DONE, don'T we'RE'LL",
    "'s 'S '\u017f 'll 'LL 'Ll x'd", "a  b   c\td\u3000e\u00a0f\u2003g\u0085h", "line\r\nline\n\n\r\nend  \n  x",
    "trailing spaces   ", "   leading", "\x1c\x1d\x1e\x1fsep", "e\u0301 vs \u00e9, A\u030a, \u212b, \u1100\u1161 vs \uac00",
    "東京の数据検索 😀🚀 naïve café Über straße", "3.14159 + 2024 = ١٢٣ ², ½", "$5 #1 email@example.com (ok?)",
    "<|im_start|><|im_end|>text<|endoftext|>more<tool_call>x</tool_call>", "<|im_start|", "",
]


def _corpus(seed: int = 0, n_lines: int = 6000) -> list:
    """Seeded lines: syllable words in several scripts, numbers,
    punctuation, contractions, emoji and every kind of spacing."""
    rng = np.random.default_rng(seed)
    cons, vows = "bcdfghjklmnprstvwz", "aeiouy"
    latin = ["".join(rng.choice(list(cons)) + rng.choice(list(vows)) for _ in range(int(rng.integers(1, 4))))
             for _ in range(1500)]
    accented = ["café", "naïve", "Über", "straße", "señor", "fjørd", "élan", "ångström", "Zürich", "crème"]
    greek = ["".join(chr(int(c)) for c in rng.integers(0x3B1, 0x3C9, int(rng.integers(2, 7)))) for _ in range(60)]
    cyrillic = ["".join(chr(int(c)) for c in rng.integers(0x430, 0x44F, int(rng.integers(2, 8)))) for _ in range(60)]
    cjk = ["".join(chr(int(c)) for c in rng.integers(0x4E00, 0x4F00, int(rng.integers(1, 4)))) for _ in range(300)]
    kana = ["".join(chr(int(c)) for c in rng.integers(0x3041, 0x3094, int(rng.integers(2, 5)))) for _ in range(60)]
    emoji = [chr(int(c)) for c in rng.integers(0x1F600, 0x1F650, 40)]
    extras = ["it's", "don't", "we're", "they've", "I'm", "you'll", "he'd", "IT'S", "3.14", "2024", "100%", "$5",
              "#1", "(a)", "[b]", "{c}", "x+y", "a/b", "--", "...", "!?", "\"q\"", "email@example.com"]
    spaces = [" "] * 30 + ["  ", "   ", "\t", "\n", "\n\n", "\r\n", " \n ", "\u3000", "\u00a0"]
    pools = [latin] * 12 + [accented, greek, cyrillic, cjk, cjk, kana, emoji, extras, extras]
    lines = []
    for _ in range(n_lines):
        words = []
        for _ in range(int(rng.integers(4, 16))):
            pool = pools[int(rng.integers(len(pools)))]
            w = str(pool[int(rng.integers(len(pool)))])
            words.append(w.capitalize() if rng.random() < 0.15 else w)
        lines.append("".join(w + spaces[int(rng.integers(len(spaces)))] for w in words))
    return lines


def write_tokenizer_fixture(path=TOKENIZER_FIXTURE, cases_path=CASES_FIXTURE) -> None:
    """Train the fixture BPE in Qwen2.5's pipeline, place Qwen2.5's special
    tokens at their ids, and write it with the package's ids of CASES."""
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, processors, trainers

    tok = Tokenizer(models.BPE(unk_token=None, byte_fallback=False))
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    trainer = trainers.BpeTrainer(vocab_size=VOCAB_SIZE, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  show_progress=False)
    tok.train_from_iterator(_corpus(), trainer)
    spec = json.loads(tok.to_str())
    for tid, content, special in QWEN_ADDED:
        spec["model"]["vocab"][content] = tid
        spec["added_tokens"].append({"id": tid, "content": content, "single_word": False, "lstrip": False,
                                     "rstrip": False, "normalized": False, "special": special})
    text = json.dumps(spec, ensure_ascii=False, separators=(",", ":"))
    path.write_text(text, encoding="utf-8")
    package = Tokenizer.from_str(text)
    cases = [{"text": s, "ids": package.encode(s, add_special_tokens=False).ids} for s in CASES]
    cases_path.write_text(json.dumps(cases, ensure_ascii=False, indent=0), encoding="utf-8")


@pytest.fixture(scope="module")
def package():
    tokenizers = pytest.importorskip("tokenizers")
    return tokenizers.Tokenizer.from_file(str(TOKENIZER_FIXTURE))


@pytest.fixture(scope="module")
def port():
    return QwenTokenizer.from_file(TOKENIZER_FIXTURE)


def test_fixture_layout_and_size():
    spec = json.loads(TOKENIZER_FIXTURE.read_text(encoding="utf-8"))
    assert TOKENIZER_FIXTURE.stat().st_size < 300_000
    assert len(spec["model"]["vocab"]) == VOCAB_SIZE + len(QWEN_ADDED)
    assert [(t["id"], t["content"]) for t in spec["added_tokens"]] == [(i, c) for i, c, _ in QWEN_ADDED]
    assert all(spec["model"]["vocab"][c] == i for i, c, _ in QWEN_ADDED)


def test_fixture_regenerates_exactly(tmp_path):
    pytest.importorskip("tokenizers")
    write_tokenizer_fixture(tmp_path / "tok.json", tmp_path / "cases.json")
    assert (tmp_path / "tok.json").read_bytes() == TOKENIZER_FIXTURE.read_bytes()
    assert (tmp_path / "cases.json").read_bytes() == CASES_FIXTURE.read_bytes()


def test_committed_cases(port, package):
    cases = json.loads(CASES_FIXTURE.read_text(encoding="utf-8"))
    assert [c["text"] for c in cases] == CASES
    for case in cases:
        assert port.encode(case["text"]) == case["ids"], case["text"]
        assert package.encode(case["text"], add_special_tokens=False).ids == case["ids"]
    prefix = next(c["ids"] for c in cases if c["text"] == CASES[0])
    assert prefix[0] == 151644 and prefix[-1] == 151652  # <|im_start|> ... <|vision_start|>, single ids
    assert next(c["ids"] for c in cases if c["text"] == "<|endoftext|>") == [151643]


_SPACES = "".join(map(chr, [*range(0x09, 0x0E), 0x1C, 0x1D, 0x1E, 0x1F, 0x20, 0x85, 0xA0, 0x1680, 0x2000, 0x2007,
                            0x200A, 0x200B, 0x2028, 0x2029, 0x202F, 0x205F, 0x3000, 0x180E, 0xFEFF]))
_ALPHABET = st.one_of(
    st.characters(categories=["L", "N", "M", "P", "S"], codec="utf-8"),
    st.characters(min_codepoint=0x4E00, max_codepoint=0x9FFF),  # CJK
    st.characters(min_codepoint=0x1F300, max_codepoint=0x1FAFF),  # emoji
    st.sampled_from(_SPACES + "\r\n'sStTmMdDlLrReEvV"),
    st.sampled_from(["\r\n", "'s", "'LL", "'Re", "'vE", "e\u0301", "\u212b", "\u1100\u1161", "<|im_start|>",
                     "<|endoftext|>", "<tool_call>", "<|im_end", "  ", "\n\n", " \n "]),
)
_TEXTS = st.lists(_ALPHABET, max_size=40).map("".join)


@settings(max_examples=400, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_TEXTS)
def test_ids_equal_the_package(port, package, text):
    assert port.encode(text) == package.encode(text, add_special_tokens=False).ids


@settings(max_examples=400, deadline=None)
@given(_TEXTS)
def test_scanner_pieces_equal_regex_findall(text):
    regex = pytest.importorskip("regex")
    text = unicodedata.normalize("NFC", text)
    assert pre_tokenize(text) == regex.findall(QWEN2_PATTERN, text)


@pytest.mark.parametrize("text,pieces", [
    ("a   b", ["a", "  ", " b"]),  # \s+(?!\S): the run's last space goes to the word
    ("a \n  b", ["a", " \n", " ", " b"]),  # \s*[\r\n]+ through the last newline
    ("x\x1cy", ["x", "\x1cy"]),  # U+001C is not White_Space
    ("'S'LL'\u017f", ["'S", "'LL", "'\u017f"]),  # case-insensitive contractions (long s folds to s)
    ("12ab", ["1", "2", "ab"]),
    ("  !!\n\nx", [" ", " !!\n\n", "x"]),
])
def test_scanner_hazards(text, pieces):
    assert pre_tokenize(text) == pieces


def test_other_layouts_raise():
    spec = json.loads(TOKENIZER_FIXTURE.read_text(encoding="utf-8"))
    for edit in (
        lambda s: s.update(normalizer={"type": "NFKC"}),
        lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(pattern={"Regex": r"\s+"}),
        lambda s: s["pre_tokenizer"]["pretokenizers"][1].update(add_prefix_space=True),
        lambda s: s["model"].update(byte_fallback=True),
        lambda s: s["model"].update(unk_token="<unk>"),
        lambda s: s["added_tokens"][0].update(normalized=True),
        lambda s: s["model"]["vocab"].pop("Ġ"),
        lambda s: s.update(model={"type": "WordPiece", "vocab": {}}),
    ):
        bad = json.loads(json.dumps(spec))
        edit(bad)
        with pytest.raises(ValueError, match="tokenizer.json"):
            QwenTokenizer(bad)


def test_scanner_equals_oniguruma_where_python_lacks_the_characters():
    """Every code point of the Unicode 16.0 table and its neighbours, and a
    stride over the whole range, in the contexts that tell a letter, a
    number, a space and any other character apart: the pieces equal the
    package's Split (Oniguruma) pre-tokenizer's."""
    tokenizers = pytest.importorskip("tokenizers")
    from morphik_core_tpu_torch.models.colqwen.tokenizer import _UNICODE_16

    split = tokenizers.pre_tokenizers.Split(tokenizers.Regex(QWEN2_PATTERN), behavior="isolated")
    cps = {c for lo, hi, _ in _UNICODE_16 for c in range(lo - 2, hi + 3)} | set(range(0, 0x110000, 97))
    for cp in sorted(cps):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        c = chr(cp)
        text = f"a{c}b {c} {c}{c}1'{c}\n{c}  {c}"
        assert pre_tokenize(text) == [p for p, _ in split.pre_tokenize_str(text)], hex(cp)
