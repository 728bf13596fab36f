"""The port's main path imports neither jax, PIL nor pydantic (none is
installed beside the card), nor anything of the JAX package: the shipped
int8 embedder calibrates its static scales from the committed pages and
serves ingest and queries, and the bf16 embedder still runs."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_GUARD = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "PIL", "pydantic"):
        sys.modules[name] = None  # any import of them now raises
    sys.path.insert(0, sys.argv[1])
    import numpy as np, torch
    torch.set_num_threads(2)
    import morphik_core_tpu_torch
    for m in pkgutil.walk_packages(morphik_core_tpu_torch.__path__, "morphik_core_tpu_torch."):
        importlib.import_module(m.name)
    import chip_smoke  # noqa: F401  (imports only; main() is not run)

    from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
    from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
    from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel, quantize_colqwen_params
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    cfg = ColQwenConfig.tiny()
    fde = FDEConfig(dimension=cfg.embedding_dim)
    rng = np.random.default_rng(0)
    pages = [(rng.integers(0, 256, (64, 588), dtype=np.uint8), (4, 4)) for _ in range(3)]
    bf16 = ColpaliEmbeddingModel(ColQwenModel.init_random(cfg, seed=0, device="cpu"))
    assert bf16._embed_prepped(pages[:1])[0].shape == (len(bf16.model.image_sequence_ids(16)), cfg.embedding_dim)
    assert "calibration_s" not in bf16.last_metrics
    model = quantize_colqwen_params(ColQwenModel.init_random(cfg, seed=0, device="cpu"))
    emb = ColpaliEmbeddingModel(model, fde_config=fde)  # the shipped config: int8 + static scales
    assert emb.last_metrics["calibration_s"] > 0
    assert all(blk.q_w.a_scale is not None and blk.down_w.a_scale is not None for blk in model.visual.blocks)
    embs, fdes = emb._embed_prepped(pages, with_fde=True)
    index = MultiVectorIndex(fde, device="cpu", pooled_tier_factor=32, device_cache_slots=64,
                             rerank_dtype="int8", device_block_rows=16)
    extra = [rng.standard_normal((40, cfg.embedding_dim)).astype(np.float32) for _ in range(20)]
    index.store(embs, [IndexRecord(f"page{i}", 0) for i in range(3)], fde_vectors=np.stack(fdes))
    index.store(extra, [IndexRecord(f"x{i}", 0) for i in range(20)])
    res = index.query(emb.embed_for_query("quarterly revenue"), k=5, return_timing=True)
    assert len(res) == 5 and index.last_timing["pooled_tier"], res
    assert index.query(extra[7], k=3)[0][0].document_id == "x7"
    leaked = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "PIL", "pydantic", "morphik_core_tpu")
                    and sys.modules[k] is not None)
    assert not leaked, leaked
    print("JAXFREE_OK")
    """
)


def test_slice_runs_with_jax_pil_pydantic_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import jax|from jax|import morphik_core_tpu\b(?!_)|from morphik_core_tpu\b(?!_))", re.M)
    files = sorted((ROOT / "morphik_core_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
