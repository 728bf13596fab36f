"""The port's kernels and int8 products on the card, each against its
plain PyTorch version, and the index's save / reopen / compaction, its
`use_pallas=False` path and a server restart there. Every test here
needs an NVIDIA sm_90 GPU with nvcc and skips elsewhere (CUDA kernels
have no CPU mode).

The file imports neither jax nor the JAX package, so it also runs on
the card's machine, which has neither (`--noconftest` skips the suite's
jax-importing conftest.py):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances:
- K1 (int8 MaxSim): per-token products are bit-identical, the f32 sum
  over query tokens reorders: rtol 1e-5, atol 1e-4;
- K2 (f32/bf16 MaxSim): the kernel splits the f32 query (and f32 docs)
  into bf16 hi + lo for the tensor cores (~2^-17 of |d||q| per dot) and
  sums in another order: rtol 1e-4, atol 1e-3;
- K3 (window attention) in f32: atol 1e-5 (summation order); in bf16
  the plain einsum rounds the scores to bf16 before the softmax and K3
  keeps them in f32, as the Pallas kernel does: atol 3e-2 on outputs of
  size ~1 (chip_smoke.py measures the gap at the path's shape). Against
  `window_attention_pallas_numerics`, which rounds where the Pallas
  kernel does: rtol 2^-7, atol 1e-3 (one bf16 ulp of an output) for all
  but at most one output in 10^6: a P whose f32 value differs by an ulp
  (exp, sum order) may round to the other bf16 neighbour and move an
  output by ulp(P) |v|, past the tight bound at a few of the path's
  22.9 M outputs;
- the int8 products: exact.
"""

import numpy as np
import pytest
import torch

from morphik_core_tpu_torch.models.colqwen.layers import QuantizedWeight, int8_dot
from morphik_core_tpu_torch.ops import _kernels
from morphik_core_tpu_torch.ops import maxsim as tmax
from morphik_core_tpu_torch.ops.window_attention import (
    window_attention,
    window_attention_pallas_numerics,
    window_attention_plain,
)

D = 32


@pytest.fixture
def sm90():
    from morphik_core_tpu_torch.device import kernels_available

    if not kernels_available():
        pytest.skip("needs an NVIDIA sm_90 GPU with nvcc (CUDA kernels have no CPU mode)")


def _pool(rng, n_cand=11, max_tok=40, empty=(3,)):
    """Ragged unit multivectors; candidates in `empty` get no tokens."""
    mvs = []
    for i in range(n_cand):
        n = 0 if i in empty else int(rng.integers(1, max_tok))
        x = rng.standard_normal((max(n, 1), D)).astype(np.float32)
        mvs.append((x / np.linalg.norm(x, axis=1, keepdims=True))[:n])
    return mvs


def _query(rng, nq):
    q = rng.standard_normal((nq, D)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.cuda
@pytest.mark.parametrize("with_idx", [False, True])
def test_kernels_match_plain_on_card(sm90, with_idx):
    """K1 and K2 against their plain versions on the card (chip_smoke.py
    runs the same checks at the path's shapes)."""
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    d8, ds, mask = (torch.from_numpy(a).to(dev) for a in tmax.quantize_pool_int8(_pool(rng)))
    q8, qs = (torch.from_numpy(a).to(dev) for a in tmax.quantize_query_q8(_query(rng, 300)))
    idx = torch.tensor([3, -1, 0, 10, 5], dtype=torch.int32, device=dev) if with_idx else None
    torch.testing.assert_close(tmax.maxsim_q8(q8, qs, d8, ds, mask, idx),
                               tmax.maxsim_q8_plain(q8, qs, d8, ds, mask, idx), rtol=1e-5, atol=1e-4)
    docs = torch.from_numpy(tmax.pad_multivectors(_pool(rng), token_bucket=40)[0]).to(dev)
    m2 = (docs.abs().sum(-1) > 0).float()
    qf = torch.from_numpy(_query(rng, 70)).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        dd = docs.to(dt)
        torch.testing.assert_close(tmax.maxsim(qf, dd, m2, idx), tmax.maxsim_plain(qf, dd, m2, idx),
                                   rtol=1e-4, atol=1e-3)


# (D, NQ, C, Np, with_idx): cases from the grid D in {16, 32, 128}, NQ in
# {1, 29, 300, 640}, C in {1, 13, 32, 304}, Np in {1, 24, 700, 1024}, plus a
# D whose rows are not 16-byte multiples (no cp.async) and a D streamed in
# two chunks.
_MAXSIM_GRID = [
    (128, 29, 32, 1024, True),  # cache rerank (K2 gets NQ unpadded)
    (128, 32, 304, 24, True),  # pooled stage: many rows of another block (-1)
    (128, 640, 13, 700, False),  # a page as the query, ragged candidates
    (128, 1, 32, 700, False),
    (16, 1, 1, 1, False),
    (16, 29, 304, 24, False),
    (16, 300, 32, 1, True),
    (32, 300, 13, 700, True),
    (32, 640, 1, 1024, False),
    (32, 29, 1, 24, True),
    (20, 29, 13, 700, True),
    (200, 70, 3, 40, False),
]


def _maxsim_case(kind, dim, nq, n_cand, np_, with_idx):
    """Seeded inputs on the card; row 0 is fully masked. With an index:
    idx[1] = -1 and idx[2] = rows (out of range) where C > 2."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(dim * 1_000_003 + nq * 1009 + n_cand * 31 + np_)
    dev = "cuda"
    rows = n_cand + 3 if with_idx else n_cand
    lengths = torch.randint(1, np_ + 1, (rows,), generator=gen, device=dev)
    lengths[0] = 0
    mask = (torch.arange(np_, device=dev)[None, :] < lengths[:, None]).float()
    if kind == "q8":
        d8 = torch.randint(-127, 128, (rows, np_, dim), generator=gen, device=dev, dtype=torch.int8)
        ds = torch.rand((rows, np_), generator=gen, device=dev) * 0.01 + 1e-3
        q8 = torch.randint(-127, 128, (nq, dim), generator=gen, device=dev, dtype=torch.int8)
        qs = torch.rand((nq,), generator=gen, device=dev) * 0.01 + 1e-3
        inputs = (q8, qs, d8, ds, mask)
    else:
        docs = torch.randn((rows, np_, dim), generator=gen, device=dev) / dim**0.5
        q = torch.randn((nq, dim), generator=gen, device=dev) / dim**0.5
        inputs = (q, docs.to(torch.bfloat16) if kind == "bf16" else docs, mask)
    idx = None
    if with_idx:
        idx = torch.randperm(rows, generator=gen, device=dev)[:n_cand].to(torch.int32)
        if n_cand > 2:
            idx[0], idx[1], idx[2] = 0, -1, rows
    return inputs, idx


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["q8", "bf16", "f32"])
@pytest.mark.parametrize("dim,nq,n_cand,np_,with_idx", _MAXSIM_GRID)
def test_maxsim_kernels_match_plain_grid(sm90, kind, dim, nq, n_cand, np_, with_idx):
    """K1 (q8) and K2 (bf16 / f32 docs) against their plain versions: a
    -1 index and a fully masked candidate score exactly 0, an index past
    the rows gives NaN, two calls are bit-identical and count two
    launches, one K1 query token is bit-exact."""
    inputs, idx = _maxsim_case(kind, dim, nq, n_cand, np_, with_idx)
    kernel, plain = (tmax.maxsim_q8, tmax.maxsim_q8_plain) if kind == "q8" else (tmax.maxsim, tmax.maxsim_plain)
    name = "maxsim_q8" if kind == "q8" else "maxsim"
    n0 = _kernels.launch_counts[name]
    got, again = kernel(*inputs, idx=idx), kernel(*inputs, idx=idx)
    torch.cuda.synchronize()
    assert _kernels.launch_counts[name] == n0 + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    rows = inputs[-1].shape[0]
    bad = torch.zeros(n_cand, dtype=torch.bool, device="cuda") if idx is None else idx >= rows
    want = plain(*inputs, idx=None if idx is None else torch.where(bad, -1, idx))
    assert got.isnan().equal(bad)
    zero = (idx if idx is not None else torch.arange(n_cand, device="cuda")) <= 0  # -1 or row 0
    assert (got[zero & ~bad] == 0).all()
    ok = ~bad
    if kind == "q8" and nq == 1:
        assert torch.equal(got[ok], want[ok])
    rtol, atol = (1e-5, 1e-4) if kind == "q8" else (1e-4, 1e-3)
    torch.testing.assert_close(got[ok], want[ok], rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,d,win,dtype,atol", [
    (17920, 16, 80, 64, torch.bfloat16, 3e-2),  # the vision tower's windowed blocks, 8 pages
    (17920, 16, 80, 64, torch.float32, 1e-5),
    (32, 3, 64, 32, torch.float32, 1e-5),  # ragged edge: one window, D = 64
    (256, 2, 128, 128, torch.float32, 1e-5),  # the kernel's largest shape
])
def test_window_attention_kernel_matches_plain(sm90, t, h, d, win, dtype, atol):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = (torch.randn((t, h, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    n0 = _kernels.launch_counts["window_attention"]
    got = window_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["window_attention"] == n0 + 1
    torch.testing.assert_close(got.float(), window_attention_plain(q, k, v, window=win).float(),
                               atol=atol, rtol=0)


def _qkv_bf16(t, h, d, seed, offset=0):
    """Seeded bf16 q/k/v on the card; with `offset`, each starts `offset`
    elements into its buffer (not 16-byte aligned)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = []
    for _ in range(3):
        buf = torch.randn((t * h * d + offset,), generator=gen, device="cuda").to(torch.bfloat16)
        out.append(buf[offset:].view(t, h, d))
    return out


# (T, H, D, window, element offset of the buffers)
_K3_BF16_SHAPES = [
    (17920, 16, 80, 64, 0),  # the vision tower's windowed blocks, 8 pages
    (1024, 4, 64, 32, 0),  # window 32, D 64
    (1024, 2, 128, 128, 0),  # the kernel's largest window and D
    (640, 4, 72, 64, 0),  # D not a multiple of 16
    (480, 4, 80, 48, 0),  # window not a multiple of 16
    (64, 1, 80, 64, 0),  # one window, one head
    (256, 3, 20, 32, 0),  # D not a multiple of 8: element copies
    (256, 2, 80, 64, 1),  # buffers off 16-byte alignment: element copies
]


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,d,win,offset", _K3_BF16_SHAPES)
def test_window_attention_bf16_kernel_matches_mirror_and_plain(sm90, t, h, d, win, offset):
    q, k, v = _qkv_bf16(t, h, d, t + h + d + win, offset)
    got = window_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (t, h, d) and torch.isfinite(got).all()
    want = window_attention_pallas_numerics(q, k, v, window=win).float()
    beyond = (got.float() - want).abs() > 1e-3 + 2**-7 * want.abs()
    assert float(beyond.float().mean()) <= 1e-6, f"{int(beyond.sum())} of {beyond.numel()} beyond the mirror's bound"
    torch.testing.assert_close(got.float(), window_attention_plain(q, k, v, window=win).float(),
                               rtol=0, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,d,win,offset", [_K3_BF16_SHAPES[0], _K3_BF16_SHAPES[4], _K3_BF16_SHAPES[6]])
def test_window_attention_bf16_kernel_two_calls_bit_identical(sm90, t, h, d, win, offset):
    q, k, v = _qkv_bf16(t, h, d, 5, offset)
    a, b = window_attention(q, k, v, window=win), window_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_attention_counts_one_launch_per_call(sm90, dtype):
    q, k, v = (x.to(dtype) for x in _qkv_bf16(512, 2, 80, 9))
    for _ in range(3):
        n0 = _kernels.launch_counts["window_attention"]
        window_attention(q, k, v, window=64)
        assert _kernels.launch_counts["window_attention"] == n0 + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_window_attention_kernel_rejects_shapes_it_does_not_take(sm90):
    q = torch.zeros((256, 2, 136), device="cuda")
    with pytest.raises(ValueError):
        window_attention(q, q, q, window=64)
    q = torch.zeros((512, 2, 64), device="cuda")
    with pytest.raises(ValueError):
        window_attention(q, q, q, window=256)


def _exact_int_product(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """int64 x8 @ w8 from f32 matmuls over 1024-wide K chunks (every
    partial sum < 1024 * 127^2 < 2^24 is an exact f32 integer; TF32 off)."""
    out = torch.zeros((x8.shape[0], w8.shape[1]), dtype=torch.int64, device=x8.device)
    for k0 in range(0, x8.shape[1], 1024):
        out += (x8[:, k0 : k0 + 1024].float() @ w8[k0 : k0 + 1024].float()).long()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("m", [17920, 2240, 32, 5])  # 8 pages, 1 page, a query bucket, < 17 rows
@pytest.mark.parametrize("k,n", [(1280, 1280), (1280, 3420), (3420, 1280), (2048, 11008), (2048, 256)])
def test_int8_product_exact_at_3b_shapes(sm90, m, k, n):
    """`torch._int_mm` through the padded leaf (3420 -> 3424) and the
    row padding of small M is the exact integer product."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(m + k + n)
    w = QuantizedWeight.from_float(torch.randn((k, n), generator=gen, device="cuda") * 0.02)
    x8 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    assert w.q8.t().is_contiguous()  # column-major: the layout cuBLASLt runs fast
    got = int8_dot(x8, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got.long(), _exact_int_product(x8, w.q8[:k, :n]))


@pytest.mark.cuda
def test_service_plane_serves_on_card(sm90, tmp_path):
    """The tiny random model (int8 + static scales, the shipped
    precision) served over HTTP on the card: one PNG ingest launches K3
    in the windowed vision blocks, one retrieve launches K1 in the int8
    rerank."""
    import asyncio
    import json
    import threading
    import time
    import urllib.request

    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.png import encode_png

    services = build_services(Settings.from_dict({
        "storage": {"storage_path": str(tmp_path / "storage")}, "database": {"path": str(tmp_path / "db.sqlite")},
        "vector_store": {"index_path": str(tmp_path / "index")},
        "telemetry": {"telemetry_dir": str(tmp_path / "logs" / "telemetry")},
        "model": {"static_act_scales": True},
    }))  # no device: the card
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=120)

    on_loop(services.initialize())
    server = HTTPServer(build_app(services), "127.0.0.1", 0)
    on_loop(server.start())
    base = f"http://127.0.0.1:{server.port}"

    def call(path, body=None, ctype="application/json"):
        req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    try:
        page = np.full((224, 336, 3), 255, np.uint8)
        page[30:80, 40:300] = (20, 90, 200)
        page[120:200:6, 20:320] = 0
        b = "card-test-boundary"
        body = (f'--{b}\r\nContent-Disposition: form-data; name="file"; filename="p.png"\r\n'
                "Content-Type: image/png\r\n\r\n").encode() + encode_png(page) + f"\r\n--{b}--\r\n".encode()
        _kernels.reset_launch_counts()
        doc = call("/ingest/file", body, f"multipart/form-data; boundary={b}")
        deadline = time.time() + 120
        while (status := call(f"/documents/{doc['external_id']}/status")["status"]) == "processing":
            assert time.time() < deadline
            time.sleep(0.05)
        assert status == "completed"
        ingest_k3 = _kernels.launch_counts["window_attention"]
        hits = call("/retrieve/chunks", json.dumps({"query": "quarterly revenue", "k": 1}).encode())
        assert [h["document_id"] for h in hits] == [doc["external_id"]] and np.isfinite(hits[0]["score"])
        health = call("/health")["components"]["colpali"]
        assert health["backend"] == torch.cuda.get_device_name(0) and health["index_rows"] == {"default": 1}
        assert ingest_k3 > 0 and _kernels.launch_counts["maxsim_q8"] > 0, dict(_kernels.launch_counts)
    finally:
        on_loop(server.stop())
        on_loop(services.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)


@pytest.mark.cuda
def test_pdf_ingest_on_card(sm90, tmp_path):
    """A 3-page PDF ingested as page images on the card (tiny random int8
    model): one forward of the three pages, K3 once in each windowed
    vision block of it; a retrieve through K1; three pages stored."""
    import asyncio
    import zlib

    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.models.schemas import AuthContext
    from morphik_core_tpu_torch.services_init import build_services

    services = build_services(Settings.from_dict({
        "storage": {"storage_path": str(tmp_path / "storage")}, "database": {"path": str(tmp_path / "db.sqlite")},
        "vector_store": {"index_path": str(tmp_path / "index")},
        "telemetry": {"telemetry_dir": str(tmp_path / "logs" / "telemetry")},
    }))  # no device: the card
    objs = [b"1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n",
            b"2 0 obj<</Type/Pages/Kids[3 0 R 5 0 R 7 0 R]/Count 3>>endobj\n"]
    for i, text in enumerate([b"quarterly revenue", b"supplier invoice AV office", b"signature page"]):
        comp = zlib.compress(b"BT /F1 12 Tf 72 720 Td (" + text + b") Tj ET")
        objs.append(f"{3 + 2 * i} 0 obj<</Type/Page/Parent 2 0 R/Contents {4 + 2 * i} 0 R>>endobj\n".encode())
        objs.append(f"{4 + 2 * i} 0 obj<</Length {len(comp)}/Filter/FlateDecode>>stream\n".encode() + comp
                    + b"\nendstream endobj\n")
    pdf = b"%PDF-1.4\n" + b"".join(objs) + b"trailer<</Root 1 0 R>>\n%%EOF"
    auth = AuthContext(entity_id="dev", permissions={"read", "write"})
    cfg = services.colpali_embedding_model.model.cfg.vision
    windowed = cfg.depth - len(cfg.fullatt_block_indexes)

    async def go():
        await services.initialize()
        try:
            doc = await services.ingestion_service.ingest_file_content(pdf, "r.pdf", {}, auth)
            _kernels.reset_launch_counts()
            doc = await services.ingestion_service.process_ingestion_job(doc.external_id, auth)
            ingest = dict(_kernels.launch_counts)
            _kernels.reset_launch_counts()
            hits = await services.document_service.retrieve_chunks("signature page", auth, k=3)
            return doc, ingest, dict(_kernels.launch_counts), hits
        finally:
            await services.shutdown()

    doc, ingest, retrieve, hits = asyncio.new_event_loop().run_until_complete(go())
    assert doc.system_metadata["page_count"] == 3 and len(doc.chunk_ids) >= 3
    assert ingest["window_attention"] == windowed, ingest
    assert retrieve["maxsim_q8"] > 0 and {h.metadata["page"] for h in hits} == {0, 1, 2}, retrieve
    assert all(h.content.startswith("data:image/jpeg;base64,") for h in hits)


@pytest.mark.cuda
def test_server_entry_point_boots_on_card(sm90, tmp_path):
    """`python -m morphik_core_tpu_torch.api.server <toml>` boots on the
    card, answers /health over a socket and drains on SIGTERM."""
    import json
    import queue
    import signal
    import subprocess
    import sys
    import threading
    import time
    import urllib.request
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    toml = tmp_path / "morphik_tpu.toml"
    toml.write_text(
        f'[api]\nhost = "127.0.0.1"\nport = 0\n[model]\nstatic_act_scales = true\n'
        f'[storage]\nstorage_path = "{tmp_path / "storage"}"\n[database]\npath = "{tmp_path / "db.sqlite"}"\n'
        f'[vector_store]\nindex_path = "{tmp_path / "index"}"\n'
        f'[telemetry]\ntelemetry_dir = "{tmp_path / "logs" / "telemetry"}"\n'
    )
    proc = subprocess.Popen([sys.executable, "-m", "morphik_core_tpu_torch.api.server", str(toml)], cwd=root,
                            stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(line) for line in proc.stderr], daemon=True)
    reader.start()
    try:
        deadline, port = time.time() + 300, None
        while port is None:
            assert time.time() < deadline and proc.poll() is None, "server did not start"
            try:
                line = lines.get(timeout=1)
            except queue.Empty:
                continue
            if "serving on 127.0.0.1:" in line:
                port = int(line.rsplit(":", 1)[1])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["components"]["colpali"]["backend"] == torch.cuda.get_device_name(0)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _index_rows(seed, n, tok=(20, 90), dim=128):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        x = rng.standard_normal((int(rng.integers(*tok)), dim)).astype(np.float32)
        rows.append((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float16))
    return rows


# morphik_tpu.toml's retrieval config (int8 ANN, pooled tier factor 32, int8
# rerank through the device cache), with small device blocks
_SHIPPED_INDEX = dict(prefilter_multiplier=30, prefilter_cap=300, ann_dtype="int8", device_cache_slots=256,
                      device_cache_token_bucket=128, rerank_dtype="int8", rerank_prefilter_pooling=4,
                      pooled_tier_factor=32, device_block_rows=128)


def _answers(index, queries, k=5):
    return [[(r.document_id, s) for r, s in index.query(q, k=k)] for q in queries]


@pytest.mark.cuda
@pytest.mark.parametrize("rerank_dtype", ["int8", "bf16"])
def test_index_save_and_reopen_on_card(sm90, tmp_path, rerank_dtype):
    """An index saved on the card and reopened with cold device state
    answers with the same ids and the same score bits (K1/K2 over rows
    read back through the mmaps)."""
    from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    kw = dict(_SHIPPED_INDEX, rerank_dtype=rerank_dtype)
    rows = _index_rows(0, 300)
    index = MultiVectorIndex(FDEConfig(), path=tmp_path / "ix", **kw)
    index.store(rows, [IndexRecord(f"d{i}", 0) for i in range(len(rows))])
    index.delete_document("d7")
    index.save()
    queries = [rows[i].astype(np.float32) for i in (3, 150, 299)] + [rows[42][:12].astype(np.float32)]
    want = _answers(index, queries)
    name = "maxsim_q8" if rerank_dtype == "int8" else "maxsim"
    n0 = _kernels.launch_counts[name]
    reopened = MultiVectorIndex(FDEConfig(), path=tmp_path / "ix", **kw)
    assert len(reopened) == 299 and reopened._persisted == 300
    assert _answers(reopened, queries) == want
    assert _kernels.launch_counts[name] > n0
    assert want[0][0][0] == "d3"


@pytest.mark.cuda
def test_compaction_on_card_equals_fresh_index_of_survivors(sm90, tmp_path):
    """The reference's trigger fires inside delete_document; the compacted
    index then answers exactly as a fresh in-memory index built from the
    survivors in row order with their stored FDE rows, and so does a
    reopen of its files after a save."""
    from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    kw = dict(_SHIPPED_INDEX, compact_min_rows=256, compact_dead_fraction=0.25)
    rows = _index_rows(1, 256)
    index = MultiVectorIndex(FDEConfig(), path=tmp_path / "ix", **kw)
    index.store(rows, [IndexRecord(f"d{i}", 0) for i in range(len(rows))])
    index.save()
    queries = [rows[i].astype(np.float32) for i in (1, 100, 200)]
    _answers(index, queries)  # warm device blocks and caches before the renumbering
    fired = 0
    for i in range(0, 240, 3):  # 80 deletes: the 65th crosses 0.25
        before = index.count_rows
        index.delete_document(f"d{i}")
        fired += index.count_rows < before
    assert fired == 1 and index.count_rows == 256 - 65 and len(index) == 256 - 80
    assert not (tmp_path / "ix.compact").exists()
    survivors = [r for r in range(index.count_rows) if index._alive[r]]
    fresh = MultiVectorIndex(FDEConfig(), **dict(_SHIPPED_INDEX))
    fresh.store([index._mv_row(r) for r in survivors],
                [IndexRecord(index.records[r].document_id, 0) for r in survivors],
                fde_vectors=index._fde_rows(0, index.count_rows)[survivors])
    want = _answers(fresh, queries)
    assert _answers(index, queries) == want
    index.save()  # the deletes after the compaction are written with the next save
    assert _answers(MultiVectorIndex(FDEConfig(), path=tmp_path / "ix", **kw), queries) == want


@pytest.mark.cuda
@pytest.mark.parametrize("rerank_dtype", ["int8", "bf16"])
def test_use_pallas_false_launches_no_kernel(sm90, rerank_dtype):
    """`use_pallas=False` (`tpu.use_pallas = false`) runs the plain versions
    on the card: the same ids as the kernels, no K1/K2 launch."""
    from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    rows = _index_rows(2, 300)
    queries = [rows[i].astype(np.float32) for i in (5, 120)] + [rows[9][:16].astype(np.float32)]
    got = {}
    for use_pallas in (None, False):
        index = MultiVectorIndex(FDEConfig(), use_pallas=use_pallas, **dict(_SHIPPED_INDEX, rerank_dtype=rerank_dtype))
        index.store(rows, [IndexRecord(f"d{i}", 0) for i in range(len(rows))])
        _kernels.reset_launch_counts()
        got[use_pallas] = _answers(index, queries)
        torch.cuda.synchronize()
        counts = dict(_kernels.launch_counts)
        launched = counts["maxsim_q8"] + counts["maxsim"]
        assert (launched > 0) == (use_pallas is None), counts
    for a, b in zip(got[None], got[False]):
        assert [d for d, _ in a] == [d for d, _ in b]
        np.testing.assert_allclose([s for _, s in b], [s for _, s in a], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_service_restart_on_card_keeps_rows(sm90, tmp_path):
    """An HTTP ingest on the card, a shutdown (which saves the index) and a
    second boot on the same directories: the row comes back with the same
    score, through K1."""
    import asyncio
    import json
    import threading
    import time
    import urllib.request

    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.png import encode_png

    raw = {
        "storage": {"storage_path": str(tmp_path / "storage")}, "database": {"path": str(tmp_path / "db.sqlite")},
        "vector_store": {"index_path": str(tmp_path / "index")},
        "telemetry": {"telemetry_dir": str(tmp_path / "logs" / "telemetry")},
        "model": {"static_act_scales": True},
    }
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=120)

    def boot():
        services = build_services(Settings.from_dict(raw))  # no device: the card
        on_loop(services.initialize())
        server = HTTPServer(build_app(services), "127.0.0.1", 0)
        on_loop(server.start())
        return services, server

    def call(server, path, body=None, ctype="application/json"):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}", data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    query = json.dumps({"query": "quarterly revenue", "k": 1}).encode()
    services, server = boot()
    try:
        page = np.full((224, 336, 3), 255, np.uint8)
        page[30:80, 40:300] = (20, 90, 200)
        b = "card-test-boundary"
        body = (f'--{b}\r\nContent-Disposition: form-data; name="file"; filename="p.png"\r\n'
                "Content-Type: image/png\r\n\r\n").encode() + encode_png(page) + f"\r\n--{b}--\r\n".encode()
        doc = call(server, "/ingest/file", body, f"multipart/form-data; boundary={b}")["external_id"]
        deadline = time.time() + 120
        while (status := call(server, f"/documents/{doc}/status")["status"]) == "processing":
            assert time.time() < deadline
            time.sleep(0.05)
        assert status == "completed"
        before = call(server, "/retrieve/chunks", query)
    finally:
        on_loop(server.stop())
        on_loop(services.shutdown())
    services, server = boot()
    try:
        _kernels.reset_launch_counts()
        after = call(server, "/retrieve/chunks", query)
        assert [(h["document_id"], h["score"]) for h in after] == [(h["document_id"], h["score"]) for h in before]
        assert after[0]["document_id"] == doc and _kernels.launch_counts["maxsim_q8"] > 0
        assert call(server, "/health")["components"]["colpali"]["index_rows"] == {"default": 1}
        assert call(server, f"/documents/{doc}")["system_metadata"]["status"] == "completed"
    finally:
        on_loop(server.stop())
        on_loop(services.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)


@pytest.mark.cuda
@pytest.mark.parametrize("hybrid", [False, True])
def test_text_store_device_scan_on_card_equals_host(sm90, monkeypatch, hybrid):
    """The text store's device scan (a buffer of `cap` rows on the card,
    `buf @ q`, `masked_fill`, `torch.topk`) answers as its host path:
    the same ids, scores within 1e-5, with and without a `doc_ids`
    filter, after an appended tail (uploaded alone) and a delete."""
    import asyncio

    from morphik_core_tpu_torch.models.schemas import DocumentChunk
    from morphik_core_tpu_torch.vector_store import text_vector_store as tvs

    rng = np.random.default_rng(17)
    words = [f"w{i}" for i in range(300)]
    store = tvs.TextVectorStore(hybrid_lexical=hybrid)  # no device: the card
    assert store.device.type == "cuda"

    def add(n, doc):
        vecs = rng.standard_normal((n, 96)).astype(np.float32)
        chunks = [DocumentChunk(document_id=f"{doc}{i // 5}", chunk_number=i % 5, embedding=v,
                                content=" ".join(rng.choice(words, int(rng.integers(5, 30)))))
                  for i, v in enumerate(vecs)]
        asyncio.run(store.store_embeddings(chunks))
        return vecs

    def both(q, **kw):
        monkeypatch.setattr(tvs, "DEVICE_SCAN_MIN_ROWS", 10**9)
        host = asyncio.run(store.query_similar(q, **kw))
        monkeypatch.setattr(tvs, "DEVICE_SCAN_MIN_ROWS", 1)
        dev = asyncio.run(store.query_similar(q, **kw))
        assert [(c.document_id, c.chunk_number) for c in dev] == [(c.document_id, c.chunk_number) for c in host]
        np.testing.assert_allclose([c.score for c in dev], [c.score for c in host], rtol=0, atol=1e-5)
        return dev

    vecs = add(3000, "d")
    ns = store._ns_map["default"]
    for step in range(3):
        for i in (3, 1200, 2999):
            text = " ".join(rng.choice(words, 3))
            for doc_ids in (None, [f"d{j}" for j in range(0, 600, 7)] + ["t3"]):
                res = both(vecs[i], k=10, doc_ids=doc_ids, query_text=text)
                assert len(res) == 10
        if step == 0:
            add(500, "t")  # a tail inside the same capacity
        elif step == 1:
            asyncio.run(store.delete_chunks_by_document_id("d240"))
            assert all(c.document_id != "d240" for c in both(vecs[1200], k=10))
    assert ns.full_uploads == 1 and ns.tail_uploads == 1 and ns.dev_buf.device.type == "cuda"


def _tiny_card_embedder():
    from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
    from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel

    return ColpaliEmbeddingModel(ColQwenModel.init_random(ColQwenConfig.tiny(), seed=0, device="cuda"))


@pytest.mark.cuda
def test_colqwen_reranker_launches_k2_on_card(sm90):
    """The reranker scores through K2 on the card; with `use_kernel=False`
    (`tpu.use_pallas=false`) it launches nothing and gives the same order
    (scores within K2's tolerance)."""
    import asyncio

    from morphik_core_tpu_torch.reranker.rerankers import ColQwenReranker

    emb = _tiny_card_embedder()
    texts = ["quarterly revenue grew in EMEA", "the signature page", "table of contents",
             "revenue " * 200, "a much longer chunk about margins and supplier invoices. " * 30]
    scores = {}
    for use_kernel in (True, False):
        _kernels.reset_launch_counts()
        scores[use_kernel] = asyncio.run(ColQwenReranker(emb, use_kernel=use_kernel).compute_score("revenue", texts))
        launches = dict(_kernels.launch_counts)
        assert launches["maxsim"] == (1 if use_kernel else 0) and launches["maxsim_q8"] == 0, launches
    np.testing.assert_allclose(scores[True], scores[False], rtol=1e-4, atol=1e-3)
    assert np.argsort(-np.asarray(scores[True])).tolist() == np.argsort(-np.asarray(scores[False])).tolist()


@pytest.mark.cuda
def test_http_text_round_trip_on_card(sm90, tmp_path):
    """The text path over HTTP on the card: `/ingest/text` with both
    `use_colpali`, a `use_colpali=false` retrieve with the ColQwen
    reranker (K2), a `use_colpali=true` retrieve of the text chunks in the
    ColPali store (K1), and a restart that keeps the text rows."""
    import asyncio
    import json
    import threading
    import urllib.request

    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.services_init import build_services

    raw = {
        "storage": {"storage_path": str(tmp_path / "storage")}, "database": {"path": str(tmp_path / "db.sqlite")},
        "vector_store": {"index_path": str(tmp_path / "index")},
        "telemetry": {"telemetry_dir": str(tmp_path / "logs" / "telemetry")},
        "model": {"static_act_scales": True}, "parser": {"chunk_size": 500, "chunk_overlap": 50},
    }
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=120)

    def boot():
        services = build_services(Settings.from_dict(raw))  # no device: the card
        on_loop(services.initialize())
        server = HTTPServer(build_app(services), "127.0.0.1", 0)
        on_loop(server.start())
        return services, server

    def call(server, path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    rng = np.random.default_rng(3)
    words = "revenue growth margin contract signature audit supplier invoice renewal clause".split()
    services, server = boot()
    try:
        docs = [call(server, "/ingest/text", {"content": " ".join(rng.choice(words, 300)), "metadata": {"i": i},
                                              "use_colpali": i == 0})["external_id"] for i in range(2)]
        plain = {"query": "supplier invoice", "k": 3, "use_colpali": False}
        before = call(server, "/retrieve/chunks", plain)
        assert len(before) == 3 and {h["document_id"] for h in before} <= set(docs)
        _kernels.reset_launch_counts()
        reranked = call(server, "/retrieve/chunks", dict(plain, use_reranking=True))
        assert len(reranked) == 3 and _kernels.launch_counts["maxsim"] == 1, dict(_kernels.launch_counts)
        _kernels.reset_launch_counts()
        colpali = call(server, "/retrieve/chunks", {"query": "supplier invoice", "k": 2, "filters": {"i": 0}})
        assert [h["document_id"] for h in colpali] == [docs[0]] * 2 and _kernels.launch_counts["maxsim_q8"] > 0
    finally:
        on_loop(server.stop())
        on_loop(services.shutdown())
    services, server = boot()
    try:
        assert call(server, "/retrieve/chunks", plain) == before
    finally:
        on_loop(server.stop())
        on_loop(services.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)


def _card_server(tmp_path):
    """The port's server on the card (tiny random int8 model, static
    scales) on a background loop -> (services, call, base, stop)."""
    import asyncio
    import json
    import threading
    import urllib.request

    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.services_init import build_services

    services = build_services(Settings.from_dict({
        "storage": {"storage_path": str(tmp_path / "storage")}, "database": {"path": str(tmp_path / "db.sqlite")},
        "vector_store": {"index_path": str(tmp_path / "index")},
        "telemetry": {"telemetry_dir": str(tmp_path / "logs" / "telemetry")},
        "model": {"static_act_scales": True},
    }))  # no device: the card
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=120)

    on_loop(services.initialize())
    server = HTTPServer(build_app(services), "127.0.0.1", 0)
    on_loop(server.start())
    base = f"http://127.0.0.1:{server.port}"

    def call(path, body=None, raw=False, ctype="application/json"):
        data = json.dumps(body).encode() if isinstance(body, dict) else body
        req = urllib.request.Request(base + path, data=data, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = resp.read()
        return out if raw else json.loads(out)

    def stop():
        on_loop(server.stop())
        on_loop(services.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)

    return services, call, base, stop


def _card_page(seed):
    rng = np.random.default_rng(seed)
    page = np.full((224, 336, 3), 255, np.uint8)
    for _ in range(6):
        y, x = int(rng.integers(0, 180)), int(rng.integers(0, 290))
        page[y : y + 40, x : x + 40] = rng.integers(0, 200, 3)
    return page


@pytest.mark.cuda
def test_embeddings_route_on_card_launches_k3_and_equals_embed_for_ingestion(sm90, tmp_path):
    """`/embeddings` of two page images on the card: K3 once in each
    windowed vision block of each tower forward (28 a forward at the 3B
    geometry; the tiny model's count here), and the npz equals
    `embed_for_ingestion` of the same chunks in process, bit for bit."""
    import io

    from morphik_core_tpu_torch.models.schemas import Chunk
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
    from morphik_core_tpu_torch.utils.png import encode_png

    services, call, _, stop = _card_server(tmp_path)
    try:
        model = services.colpali_embedding_model.model
        windowed = model.cfg.vision.depth - len(model.cfg.vision.fullatt_block_indexes)
        forwards = []
        tower = model.embed_image_batch

        def counted(patches, *a, **kw):
            forwards.append(int(patches.shape[0]))
            return tower(patches, *a, **kw)

        model.embed_image_batch = counted
        images = [bytes_to_data_uri(encode_png(_card_page(s)), "image/png") for s in (1, 2)]
        _kernels.reset_launch_counts()
        npz = np.load(io.BytesIO(call("/embeddings", {"input_type": "image", "inputs": images}, raw=True)))
        launches = dict(_kernels.launch_counts)
        assert forwards and launches["window_attention"] == windowed * len(forwards), (launches, forwards)
        want = services.colpali_embedding_model.embed_for_ingestion_sync(
            [Chunk(content=u, metadata={"is_image": True}) for u in images])[0]
        assert npz.files == ["emb_0", "emb_1"]
        for i, w in enumerate(want):
            assert np.array_equal(npz[f"emb_{i}"], w)
        model.embed_image_batch = tower
    finally:
        stop()


@pytest.mark.cuda
def test_device_profile_route_on_card_names_the_maxsim_kernel(sm90, tmp_path):
    """`/logs/profile/device` for 2 s while another thread retrieves: the
    Chrome trace names `maxsim_mma_kernel` (CUPTI records the kernels of
    every thread)."""
    import threading
    import time
    from pathlib import Path

    from morphik_core_tpu_torch.utils.png import encode_png

    services, call, _, stop = _card_server(tmp_path)
    try:
        b = "card-profile-boundary"
        body = (f'--{b}\r\nContent-Disposition: form-data; name="file"; filename="p.png"\r\n'
                "Content-Type: image/png\r\n\r\n").encode() + encode_png(_card_page(3)) + f"\r\n--{b}--\r\n".encode()
        doc = call("/ingest/file", body, ctype=f"multipart/form-data; boundary={b}")
        deadline = time.time() + 120
        while call(f"/documents/{doc['external_id']}/status")["status"] == "processing":
            assert time.time() < deadline
            time.sleep(0.05)
        halt = threading.Event()
        n = [0]

        def retrieves():
            while not halt.is_set():
                call("/retrieve/chunks", {"query": "quarterly revenue", "k": 1})
                n[0] += 1

        t = threading.Thread(target=retrieves)
        t.start()
        try:
            out = call("/logs/profile/device", {"seconds": 2})
        finally:
            halt.set()
            t.join(timeout=60)
        trace = (Path(out["trace_dir"]) / "trace.json").read_text()
        assert n[0] > 0 and "maxsim_mma_kernel" in trace, (n[0], len(trace))
    finally:
        stop()
