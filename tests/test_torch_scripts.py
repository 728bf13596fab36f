"""The port's operator scripts (`morphik_core_tpu_torch/scripts/`) against
the originals in `scripts/`, on the CPU.

Each pair runs on two copies of one seeded tree (a sqlite database, local
storage with page payloads, raw uploads, text-index files and an app
registry, and a multivector index in two namespaces), the original on
one, the twin (`--device cpu`) on the other. The JSON reports must match
(paths compared relative to each tree), and the trees left behind must be
byte-identical, file for file. Two files hold floats the two packages
compute in another order: an `fde.bin` that a script re-encodes
(`rebuild_fde`, `migrate_store_provider`), compared within the FDE parity
tolerance of tests/test_torch_fde.py (atol 1e-5).

The twin's two refusals stand beside the original's behaviour on the same
tree: `check_completeness --gc-apply` with an empty index root (the
original deletes every payload; the twin deletes nothing and exits 2),
and `migrate_store_provider --to binary` (the original fails on every
document with a TypeError, then raises an AttributeError at its save;
the twin exits 2 and writes nothing). The soak twin passes its rule on a
CPU server, with the original's report keys.
"""

import asyncio
import gc
import json
import re
import shutil
import sqlite3
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
from morphik_core_tpu_torch.ops.fde import FDEConfig
from morphik_core_tpu_torch.scripts import (
    check_completeness as t_check,
    export_chunks_resumable as t_export,
    migrate_index_format as t_migrate_format,
    migrate_store_provider as t_migrate_provider,
    purge_app as t_purge,
    rebuild_fde as t_rebuild,
    scrub_metadata as t_scrub,
    soak_serving as t_soak,
)
from morphik_core_tpu_torch.services.user_service import UserService
from morphik_core_tpu_torch.storage.local_storage import LocalStorage
from scripts import (
    check_completeness as j_check,
    export_chunks_resumable as j_export,
    migrate_index_format as j_migrate_format,
    migrate_store_provider as j_migrate_provider,
    purge_app as j_purge,
    rebuild_fde as j_rebuild,
    scrub_metadata as j_scrub,
)

torch.set_num_threads(2)

DIM = 16
FDE_KW = dict(dimension=DIM, num_repetitions=4, num_simhash_projections=3, projection_dimension=8)
BUCKET = "multivector-chunks"
CPU = ["--device", "cpu"]


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _config(root: Path, index_path: Path = None) -> Path:
    cfg = root.parent / f"{root.name}.toml"
    cfg.write_text(f"""
[model]
embedding_dim = {DIM}

[database]
path = "{root / 'db.sqlite'}"

[storage]
provider = "local"
storage_path = "{root / 'store'}"

[vector_store]
index_path = "{index_path or root / 'index'}"
fde_num_repetitions = 4
fde_num_simhash_projections = 3
fde_projection_dimension = 8
""")
    return cfg


def _seed(root: Path, index_sub: str = "index") -> None:
    """Two namespaces as ingest lays them out, with every kind of fault
    check_completeness reports: a completed document whose chunk the index
    lacks (d4), index rows of a document gone from the DB (d3) and of a
    failed one (a1), a missing payload (d1 chunk 1), an orphan payload and
    an orphan raw upload."""
    rng = np.random.default_rng(0)
    storage = LocalStorage(root / "store")
    db = SQLiteDatabase(root / "db.sqlite")
    _run(db.initialize())
    db.close()
    conn = sqlite3.connect(root / "db.sqlite")
    for ns, docs in (("default", ["d0", "d1", "d2", "d3"]), ("app1", ["a0", "a1"])):
        idx = MultiVectorIndex(FDEConfig(**FDE_KW), path=root / index_sub / ns, device="cpu")
        mvs, recs = [], []
        for doc in docs:
            for c in range(2):
                key = f"{ns}/{doc}/{c}.jpg"
                _run(storage.upload_file(b"payload-" + key.encode(), key, bucket=BUCKET))
                mvs.append(rng.standard_normal((int(rng.integers(3, 9)), DIM)).astype(np.float32))
                recs.append(IndexRecord(document_id=doc, chunk_number=c, content_key=key,
                                        metadata={"external_id": doc, "secret": f"{doc}{c}", "page": c}))
        idx.store(mvs, recs)
        idx.save()
        app_id = None if ns == "default" else ns
        for doc in docs + (["d4"] if ns == "default" else []):
            if doc == "d3":
                continue
            raw_key = f"ingest/{doc}/file.pdf"
            _run(storage.upload_file(b"raw-" + doc.encode(), raw_key))
            conn.execute(
                "INSERT INTO documents (external_id, app_id, status, chunk_ids, storage_info, content_type,"
                " doc_metadata) VALUES (?,?,?,?,?,?,?)",
                (doc, app_id, "failed" if doc == "a1" else "completed",
                 json.dumps([f"{doc}-{c}" for c in range(2)]), json.dumps({"bucket": "", "key": raw_key}),
                 "application/pdf", json.dumps({"external_id": doc, "secret": "x", "title": doc.upper()})),
            )
        if app_id:
            conn.execute("INSERT INTO chats (chat_id, app_id) VALUES (?,?)", (f"chat-{ns}", app_id))
            conn.execute("INSERT INTO storage_usage (app_id, owner_id, bytes) VALUES (?,?,?)", (app_id, "u1", 1000))
    conn.commit()
    conn.close()
    _run(storage.delete_file(BUCKET, "default/d1/1.jpg"))
    _run(storage.upload_file(b"orphan", "default/gone/0.jpg", bucket=BUCKET))
    _run(storage.upload_file(b"zombie", "ingest/ghost/file.pdf"))
    text_root = root / "store" / "text_index"
    text_root.mkdir(parents=True)
    for name in ("app1.rows.json", "app1.vecs.npy", "default.rows.json"):
        (text_root / name).write_bytes(name.encode())
    us = UserService(path=root / "store" / "user_limits.db")
    _run(us.register_app("app1", "app1", "u1", "morphik://app1"))
    us.close()


@pytest.fixture
def trees(tmp_path):
    """-> (jax tree, torch tree, jax config, torch config): two copies of
    one seeded tree."""
    j, t = tmp_path / "j", tmp_path / "t"
    _seed(j)
    shutil.copytree(j, t)
    return j, t, _config(j), _config(t)


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _same_tree(j: Path, t: Path, float_files=()) -> None:
    a, b = _files(j), _files(t)
    assert sorted(a) == sorted(b)
    for name in a:
        if name.endswith(float_files):
            x, y = np.frombuffer(a[name], np.float32), np.frombuffer(b[name], np.float32)
            assert x.shape == y.shape, name
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-5, err_msg=name)
        else:
            assert a[name] == b[name], name


def _out(capsys):
    return capsys.readouterr().out


def _json_docs(text: str) -> list:
    """The JSON documents printed one after another in `text`."""
    dec, docs, i = json.JSONDecoder(), [], 0
    while (i := text.find("{", i)) >= 0:
        doc, i = dec.raw_decode(text, i)
        docs.append(doc)
    return docs


def _json_out(capsys):
    """The one JSON report printed since the last read."""
    (doc,) = _json_docs(_out(capsys))
    return doc


# ------------------------------------------------------ check_completeness


def test_check_completeness_twin(trees, capsys):
    j, t, jcfg, tcfg = trees
    rc_j = j_check.main(["--config", str(jcfg)])
    rep_j = _json_out(capsys)
    rc_t = t_check.main(["--config", str(tcfg), *CPU])
    rep_t = _json_out(capsys)
    assert rc_j == rc_t == 1 and rep_t == rep_j
    assert {m["chunk_id"] for m in rep_t["missing_index_rows"]} == {"d4-0", "d4-1"}
    assert {o["document_id"] for o in rep_t["orphan_index_rows"]} == {"d3", "a1"}
    assert [m["content_key"] for m in rep_t["missing_payloads"]] == ["default/d1/1.jpg"]
    _same_tree(j, t)
    rc_j = j_check.main(["--config", str(jcfg), "--gc-apply"])
    rep_j = _json_out(capsys)
    rc_t = t_check.main(["--config", str(tcfg), "--gc-apply", *CPU])
    rep_t = _json_out(capsys)
    assert rc_j == rc_t == 1 and rep_t == rep_j and rep_t["gc_applied"] == 2
    _same_tree(j, t)
    assert not (t / "store" / BUCKET / "default" / "gone" / "0.jpg").exists()


def test_gc_apply_on_an_empty_index_root_is_refused(tmp_path, capsys):
    """vector_store.index_path names an empty directory (a wrong path):
    the original's plan lists every payload as an orphan and deletes them
    all; the twin lists them too, deletes nothing and exits 2."""
    j, t = tmp_path / "j", tmp_path / "t"
    _seed(j)
    shutil.copytree(j, t)
    (tmp_path / "empty_j").mkdir()
    (tmp_path / "empty_t").mkdir()
    jcfg, tcfg = _config(j, tmp_path / "empty_j"), _config(t, tmp_path / "empty_t")
    before = _files(t)
    n_payloads = len([k for k in before if k.startswith(f"store/{BUCKET}/")])
    assert j_check.main(["--config", str(jcfg), "--gc-apply"]) == 0
    rep_j = _json_out(capsys)
    assert rep_j["gc_applied"] == n_payloads + 1  # every payload and the orphan raw upload: fails open
    assert not [k for k in _files(j) if k.startswith(f"store/{BUCKET}/")]
    assert t_check.main(["--config", str(tcfg), "--gc-apply", *CPU]) == 2
    rep_t = _json_out(capsys)
    assert rep_t["gc_refused"] == t_check.GC_REFUSED_EMPTY_ROOT and "gc_applied" not in rep_t
    assert rep_t["gc_plan"] == rep_j["gc_plan"] and len(rep_t["gc_plan"]["orphan_payload_objects"]) == n_payloads
    assert _files(t) == before
    # without --gc-apply the twin reports as the original does
    assert t_check.main(["--config", str(tcfg), *CPU]) == 0
    assert "gc_refused" not in _json_out(capsys)


# --------------------------------------------------------------- purge_app


@pytest.mark.parametrize("app", ["app1", "default"])
def test_purge_app_twin(trees, capsys, app):
    j, t, jcfg, tcfg = trees
    for main, cfg, extra in ((j_purge.main, jcfg, []), (t_purge.main, tcfg, CPU)):
        assert main(["--config", str(cfg), "--app-id", app, "--dry-run", *extra]) == 0
    plan_j, plan_t = _json_docs(_out(capsys).replace(str(t), str(j)))
    assert plan_t == plan_j and not plan_t["plan"]["empty"]
    _same_tree(j, t)
    assert j_purge.main(["--config", str(jcfg), "--app-id", app, "--yes"]) == 0
    out_j = _out(capsys)
    assert t_purge.main(["--config", str(tcfg), "--app-id", app, "--yes", *CPU]) == 0
    out_t = _out(capsys)
    assert out_t.replace(str(t), str(j)) == out_j and '"purged"' in out_t
    _same_tree(j, t)
    assert not (t / "index" / app).exists()


# ------------------------------------------------------------- rebuild_fde


def test_rebuild_fde_twin(trees, capsys, monkeypatch):
    j, t, _, _ = trees
    new = ["--dimension", str(DIM), "--num-repetitions", "6", "--num-simhash-projections", "2",
           "--projection-dimension", "4", "--batch", "3"]
    monkeypatch.setattr(sys, "argv", ["rebuild_fde.py", "--index-path", str(j / "index"), *new])
    assert j_rebuild.main() == 0
    assert t_rebuild.main(["--index-path", str(t / "index"), *new, *CPU]) == 0
    _same_tree(j, t, float_files=("fde.bin",))
    cfg = FDEConfig(dimension=DIM, num_repetitions=6, num_simhash_projections=2, projection_dimension=4)
    idx = MultiVectorIndex(cfg, path=t / "index" / "default", device="cpu")
    assert len(idx) == 8
    q = idx.get_multivector("d2", 1)
    assert idx.query(q, k=1)[0][0].document_id == "d2"
    lines = re.sub(r"\d+\.\ds", "", _out(capsys)).split()
    assert lines.count("default:") == 2 and lines.count("app1:") == 2


# ---------------------------------------------------- migrate_index_format


def _legacy(path: Path, rng) -> None:
    (path / "multivectors").mkdir(parents=True)
    recs = []
    for i in range(6):
        recs.append({"document_id": f"old{i}", "chunk_number": 0, "metadata": {"i": i}, "content_key": None,
                     "n_tokens": 5, "alive": i != 2})
        np.save(path / "multivectors" / f"{i}.npy", rng.standard_normal((5, DIM)).astype(np.float16))
    np.save(path / "fde.npy", rng.standard_normal((6, FDEConfig(**FDE_KW).fde_dim)).astype(np.float32))
    (path / "meta.json").write_text(json.dumps({"count": 6, "fde": {}, "records": recs}))


def test_migrate_index_format_twin(trees, capsys, monkeypatch):
    j, t, jcfg, tcfg = trees
    for root in (j, t):
        _legacy(root / "index" / "legacy", np.random.default_rng(4))
    monkeypatch.setattr(sys, "argv", ["migrate_index_format.py", "--index-path", str(j / "index"), "--config",
                                      str(jcfg), "--query-smoke"])
    assert j_migrate_format.main() == 0
    out_j = _out(capsys)
    assert t_migrate_format.main(["--index-path", str(t / "index"), "--config", str(tcfg), "--query-smoke",
                                  *CPU]) == 0
    out_t = _out(capsys)
    assert re.sub(r"in \d+\.\ds", "", out_t) == re.sub(r"in \d+\.\ds", "", out_j)
    assert "legacy: migrated 5 rows" in out_t and "default: already append-only" in out_t
    _same_tree(j, t)
    assert not (t / "index" / "legacy" / "meta.json").exists()


# ------------------------------------------------- export_chunks_resumable


def test_export_twin_and_resume(trees, capsys):
    j, t, jcfg, tcfg = trees
    assert j_export.main(["--config", str(jcfg), "--out", str(j / "export"), "--batch", "3"]) == 0
    out_j = _out(capsys)
    assert t_export.main(["--config", str(tcfg), "--out", str(t / "export"), "--batch", "3", *CPU]) == 0
    assert _out(capsys) == out_j and json.loads(out_j)["exported"] == 12
    _same_tree(j, t)
    # interrupted after the run's first shard (app1's rows 0-2), then
    # resumed: the same bytes, and the first shard is not written again
    ns = t / "export" / "app1"
    (t / "export" / "checkpoint.json").write_text(json.dumps({"app1": 3}))
    for p in [*ns.glob("shard_00001.*"), ns / "manifest.json"]:
        p.unlink()
    shutil.rmtree(t / "export" / "default")
    shard0 = (ns / "shard_00000.npy").stat().st_mtime_ns
    assert t_export.main(["--config", str(tcfg), "--out", str(t / "export"), "--batch", "3", *CPU]) == 0
    assert _out(capsys) == out_j
    assert (ns / "shard_00000.npy").stat().st_mtime_ns == shard0
    _same_tree(j, t)


# ---------------------------------------------------------- scrub_metadata


def test_scrub_metadata_twin(trees, capsys):
    j, t, jcfg, tcfg = trees
    dry = ["--keep", "external_id,title", "--dry-run-index", "--batch", "2"]
    assert j_scrub.main(["--config", str(jcfg), *dry]) == 0
    out_j = _out(capsys)
    assert t_scrub.main(["--config", str(tcfg), *dry, *CPU]) == 0
    assert _out(capsys) == out_j
    assert json.loads(out_j) == {"documents_scrubbed": 6, "index_records_scrubbed": 12, "applied": False}
    _same_tree(j, t)
    apply = ["--keep", "external_id,title", "--apply", "--batch", "2"]
    assert j_scrub.main(["--config", str(jcfg), *apply]) == 0
    out_j = _out(capsys)
    assert t_scrub.main(["--config", str(tcfg), *apply, *CPU]) == 0
    assert _out(capsys) == out_j and json.loads(out_j)["applied"]
    _same_tree(j, t)
    conn = sqlite3.connect(t / "db.sqlite")
    assert json.loads(conn.execute("SELECT doc_metadata FROM documents WHERE external_id='d0'").fetchone()[0]) == {
        "external_id": "d0", "title": "D0"}
    conn.close()


# ------------------------------------------------- migrate_store_provider


def _provider_tree(trees):
    """The fde provider's store under {index_path}/provider_fde. Both
    scripts list documents as the developer "migration" (self-hosted
    access: `owner_id = 'migration'`), so the documents are given that
    owner: otherwise both migrate nothing."""
    j, t, jcfg, tcfg = trees
    for root in (j, t):
        shutil.move(root / "index" / "default", root / "index" / "provider_fde" / "default")
        shutil.move(root / "index" / "app1", root / "index" / "provider_fde" / "app1")
        conn = sqlite3.connect(root / "db.sqlite")
        conn.execute("UPDATE documents SET owner_id = 'migration'")
        conn.commit()
        conn.close()
        _run(LocalStorage(root / "store").upload_file(b"payload-default/d1/1.jpg", "default/d1/1.jpg", bucket=BUCKET))
    return j, t, jcfg, tcfg


def test_migrate_store_provider_fde_to_fde(trees, capsys, monkeypatch):
    j, t, jcfg, tcfg = _provider_tree(trees)
    for root, cfg, run in ((j, jcfg, None), (t, tcfg, t_migrate_provider.main)):
        argv = ["--config", str(cfg), "--from", "fde", "--to", "fde", "--checkpoint", str(root / "ckpt.json")]
        if run is None:
            monkeypatch.setattr(sys, "argv", ["migrate_store_provider.py", *argv])
            assert j_migrate_provider.main() == 0
        else:
            assert run([*argv, *CPU]) == 0
    out = _out(capsys).splitlines()
    assert out[0] == out[1] == "done: migrated=6 skipped=0 errors=0"  # d4 has no rows: migrated empty
    gc.collect()  # the original leaves its database open: closing it folds the WAL into the file
    _same_tree(j, t, float_files=("fde.bin",))
    assert json.loads((t / "ckpt.json").read_text())["migrated"] == ["a0", "a1", "d0", "d1", "d2", "d4"]


def test_migrate_store_provider_to_binary(trees, capsys, monkeypatch):
    """The original fails on every document (TypeError: the binary index
    takes no `fde_vectors`) and then raises at `dst.save()` (the binary
    index has no `path`); the twin refuses before it reads anything."""
    j, t, jcfg, tcfg = _provider_tree(trees)
    before = _files(t)
    monkeypatch.setattr(sys, "argv", ["migrate_store_provider.py", "--config", str(jcfg), "--from", "fde", "--to",
                                      "binary", "--checkpoint", str(j / "ckpt.json")])
    with pytest.raises(AttributeError, match="path"):
        j_migrate_provider.main()
    out = _out(capsys)
    assert out.count("ERROR migrating") == 5 and out.count("fde_vectors") == 5
    assert json.loads((j / "ckpt.json").read_text()) == {"migrated": ["d4"]}  # the one without rows
    assert t_migrate_provider.main(["--config", str(tcfg), "--from", "fde", "--to", "binary",
                                    "--checkpoint", str(t / "ckpt.json"), *CPU]) == 2
    assert t_migrate_provider.REFUSE_TO_BINARY in capsys.readouterr().err
    assert _files(t) == before


# ------------------------------------------------------------ soak_serving


def test_soak_twin_passes_on_the_cpu(tmp_path):
    """Two seconds of the soak on a CPU server of the development model:
    the original's report keys, traffic of every kind, its pass rule."""
    out = _run(t_soak.run_soak(2, str(tmp_path / "soak"), device="cpu"))
    assert set(out) == {"ingest", "retrieve", "query", "filtered", "errors", "client_timeouts", "n_errors",
                        "warmup_s", "drained", "pending_after_drain"}
    assert out["ingest"] > 0 and out["retrieve"] > 0 and out["filtered"] > 0 and out["query"] > 0
    assert t_soak.passed(out), out


def test_soak_page_is_a_png_with_text():
    from morphik_core_tpu_torch.utils.png import decode_png

    a, b = decode_png(t_soak.page_png(1)), decode_png(t_soak.page_png(2))
    assert a.shape == (240, 320, 3) and (a < 128).any() and not np.array_equal(a, b)


def test_twins_import_nothing_of_the_reference():
    pattern = re.compile(r"^\s*(import|from) (morphik_core_tpu|scripts)\b(?!_)", re.M)
    files = sorted((Path(t_check.__file__).parent).glob("*.py"))
    assert len(files) >= 9
    assert not [f.name for f in files if pattern.search(f.read_text())]
