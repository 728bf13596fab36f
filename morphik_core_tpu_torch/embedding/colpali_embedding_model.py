"""ColPali embedding model of the port: pages and queries -> per-token
multivectors on the device. PyTorch port of
`morphik_core_tpu/embedding/colpali_embedding_model.py:141-242, 323-348`.

Explicit keyword settings replace the reference's pydantic `Settings`
(batch 8, the pixel bounds and the W8A8 serving mode of
`morphik_tpu.toml`). Pages are grouped by grid bucket and embedded in
batches; on the ingest path the document FDE is computed on the device
right after the tower forward, on the still-resident multivectors (the
fused ingest FDE).

Handed an int8 model with `static_act_scales=True` (the shipped config),
construction calibrates the int8 vision tower's static activation
scales on the committed calibration pages. A calibration
failure raises: the reference logs it and serves dynamic quantization,
a different precision than the one configured.

Service-plane entry points (`embedding/colpali_embedding_model.py:246-327`
of the reference): `embed_for_ingestion_sync` / `embed_for_ingestion`
take `Chunk`s, whose metadata may carry the page's `_patches` computed
at upload (the reference's prep mode), and `embed_for_query` takes a
text or a decoded (H, W, 3) uint8 page. `from_settings` maps the
reference's `Settings`.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from morphik_core_tpu_torch.models.colqwen.calibrate import calibration_batches, load_calibration_pages
from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel, quantize_colqwen_params
from morphik_core_tpu_torch.models.colqwen.preprocess import preprocess_array_u8, preprocess_image_u8
from morphik_core_tpu_torch.models.schemas import Chunk
from morphik_core_tpu_torch.ops.fde import FDEConfig, fde_document_batch
from morphik_core_tpu_torch.parallel.mesh import shard_colqwen_params
from morphik_core_tpu_torch.utils.fast_ops import data_uri_to_bytes
from morphik_core_tpu_torch.utils.image import decode_image
from morphik_core_tpu_torch.utils.jpeg import decode_own

logger = logging.getLogger(__name__)

Prepped = Tuple[np.ndarray, Tuple[int, int]]

CALIBRATION_BATCH = 8  # the reference's calibration batch


class ColpaliEmbeddingModel:
    def __init__(
        self,
        model: ColQwenModel,
        *,
        batch_size: int = 8,
        min_pixels: int = 3136,
        max_pixels: int = 602112,
        fde_config: Optional[FDEConfig] = None,
        static_act_scales: bool = True,
    ):
        """The model's own precision is served: an int8 model
        (`quantize_colqwen_params`) is calibrated here unless
        `static_act_scales` is off. `fde_config` set: the ingest path
        (`_embed_prepped(..., with_fde=True)`) also returns per-page
        document FDE rows."""
        self.model = model
        self.batch_size = max(1, int(batch_size))
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.fde_config = fde_config
        self.last_metrics: Dict[str, float] = {}
        if static_act_scales and model.matmul_precision == "int8":
            t0 = time.perf_counter()
            u8, (hu, wu) = load_calibration_pages()
            model.calibrate_static_act_scales(calibration_batches(u8, CALIBRATION_BATCH), hu, wu)
            self.last_metrics["calibration_s"] = time.perf_counter() - t0
            logger.info("static activation scales calibrated in %.1fs", self.last_metrics["calibration_s"])

    @classmethod
    def from_settings(cls, settings, model: Optional[ColQwenModel] = None, device=None,
                      fde_config: Optional[FDEConfig] = None, mesh=None) -> "ColpaliEmbeddingModel":
        """The embedder `Settings` describe: `tpu.embed_batch_size`,
        `model.min_pixels` / `max_pixels` and `model.static_act_scales`.
        A given model must have the configured `model.matmul_precision`
        and `attention_precision`, and with `mesh` be on that mesh. Without
        one, `model.checkpoint_path` is loaded on `device` (or onto `mesh`)
        in both precisions (`colpali_embedding_model.py:53-60`); without
        that, development mode serves the tiny random model in them
        (`:61-82`) and any other environment raises rather than serve
        random embeddings. The batch stays `tpu.embed_batch_size` on a
        mesh too (the model pads it to the data axis)."""
        precision = settings.model.matmul_precision
        attention = settings.model.attention_precision
        load_s = None
        if model is None and settings.model.checkpoint_path:
            t0 = time.perf_counter()
            model = ColQwenModel.from_checkpoint(settings.model.checkpoint_path, device=device,
                                                 matmul_precision=precision, attention_precision=attention,
                                                 mesh=mesh)
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)
            load_s = time.perf_counter() - t0
            logger.info("checkpoint %s loaded in %.1fs", settings.model.checkpoint_path, load_s)
        elif model is None:
            if settings.service.environment != "development":
                raise RuntimeError(
                    "no ColQwen model given, model.checkpoint_path is not set and service.environment="
                    f"{settings.service.environment!r}: refusing to serve random-weight embeddings "
                    "outside development mode"
                )
            logger.warning("no model given: serving a tiny random ColQwen (development mode)")
            model = ColQwenModel.init_random(ColQwenConfig.tiny(), seed=0,
                                             device=device if mesh is None else mesh.first_device,
                                             attention_precision=attention)
            if precision == "int8":
                quantize_colqwen_params(model)
            if mesh is not None:  # shards after quantizing, as the reference
                shard_colqwen_params(model, mesh)
        elif (model.matmul_precision, model.attention_precision) != (precision, attention):
            raise ValueError(
                f"the model serves matmul_precision={model.matmul_precision!r}, attention_precision="
                f"{model.attention_precision!r}; the settings configure {precision!r}, {attention!r}"
            )
        elif mesh is not None and model.mesh is not mesh:
            raise ValueError(f"the given model is on mesh {model.mesh}, the services on {mesh}")
        out = cls(model, batch_size=settings.tpu.embed_batch_size, min_pixels=settings.model.min_pixels,
                  max_pixels=settings.model.max_pixels, fde_config=fde_config,
                  static_act_scales=settings.model.static_act_scales)
        if load_s is not None:
            out.last_metrics["checkpoint_load_s"] = load_s
        return out

    @property
    def embedding_dim(self) -> int:
        return self.model.cfg.embedding_dim

    @property
    def device(self) -> torch.device:
        """Where the tower runs; a JPEG 2000 page's tier-1 (K5) runs there too."""
        return self.model.device

    def prep_images(self, images: Sequence["object"]) -> List[Prepped]:
        """PIL images or decoded (H, W, 3) uint8 pages -> (uint8 patches
        (S, 588), grid) pairs."""
        return [
            preprocess_array_u8(im, min_pixels=self.min_pixels, max_pixels=self.max_pixels)
            if isinstance(im, np.ndarray)
            else preprocess_image_u8(im, min_pixels=self.min_pixels, max_pixels=self.max_pixels)
            for im in images
        ]

    def embed_images(self, images, with_fde: bool = False):
        t0 = time.perf_counter()
        prepped = self.prep_images(images)
        return self._embed_prepped(prepped, with_fde=with_fde, prep_s=time.perf_counter() - t0)

    def _embed_prepped(self, prepped: List[Prepped], with_fde: bool = False, prep_s: float = 0.0):
        """Bucket-group + batched forward over (u8 patches, grid) pairs.
        Order-preserving. Returns embeddings, or (embeddings, fde rows)
        with `with_fde=True` (FDE rows are None without `fde_config`)."""
        buckets: Dict[Tuple[int, int], List[Tuple[int, np.ndarray]]] = {}
        for i, (patches, grid) in enumerate(prepped):
            buckets.setdefault(tuple(grid), []).append((i, patches))
        t0 = time.perf_counter()
        out: List[Optional[np.ndarray]] = [None] * len(prepped)
        out_fde: List[Optional[np.ndarray]] = [None] * len(prepped)
        fuse_fde = with_fde and self.fde_config is not None
        for (hu, wu), items in buckets.items():
            for s in range(0, len(items), self.batch_size):
                batch = items[s : s + self.batch_size]
                dev = self.model.embed_image_batch(np.stack([p for _, p in batch]), hu, wu, as_device=True)
                if fuse_fde:
                    # every token inside a grid bucket is valid: mask of ones
                    ones = torch.ones(dev.shape[:2], dtype=torch.float32, device=dev.device)
                    fdes = fde_document_batch(dev, ones, self.fde_config).cpu().numpy()
                embs = dev.cpu().numpy()
                for j, (i, _) in enumerate(batch):
                    out[i] = embs[j]
                    if fuse_fde:
                        out_fde[i] = fdes[j]
        self.last_metrics.update(
            image_preprocess_s=prep_s, image_model_s=time.perf_counter() - t0,
            image_count=len(prepped), buckets=len(buckets),
        )
        return (out, out_fde) if with_fde else out

    def embed_texts(self, texts: List[str]) -> List[np.ndarray]:
        t0 = time.perf_counter()
        out: List[np.ndarray] = []
        for s in range(0, len(texts), self.batch_size):
            out.extend(self.model.embed_queries(texts[s : s + self.batch_size]))
        self.last_metrics.update(text_model_s=time.perf_counter() - t0, text_count=len(texts))
        return out

    def embed_query(self, query: Union[str, np.ndarray, "object"]) -> np.ndarray:
        """A text, a decoded (H, W, 3) uint8 page or a PIL image ->
        (n_tokens, dim) f32."""
        if isinstance(query, str):
            return self.embed_texts([query])[0]
        if isinstance(query, np.ndarray):
            prepped = preprocess_array_u8(query, min_pixels=self.min_pixels, max_pixels=self.max_pixels)
            return self._embed_prepped([prepped])[0]
        return self.embed_images([query])[0]

    async def embed_for_query(self, query: Union[str, np.ndarray]) -> np.ndarray:
        """`embed_query` for the service plane (the reference's async API),
        in a worker thread: the event loop keeps serving meanwhile."""
        return await asyncio.to_thread(self.embed_query, query)

    def embed_for_ingestion_sync(
        self, chunks: Union[Chunk, List[Chunk]]
    ) -> Tuple[List[np.ndarray], List[Optional[np.ndarray]]]:
        """Chunks -> (embeddings, fused FDE rows), chunk-aligned
        (`colpali_embedding_model.py:259-320`). An image chunk whose
        metadata carries `_patches` (computed at raster time) is embedded
        from them; another image chunk from its decoded payload: the
        coefficients in `_jpeg` through `jpeg.decode_own` when the port's
        own encoder wrote it, else its PNG or JPEG bytes; text chunks go
        through the text tower (their FDE row is None). The
        ingestion service runs this in worker threads: results flow
        through return values only."""
        if isinstance(chunks, Chunk):
            chunks = [chunks]
        if not chunks:
            return [], []
        t0 = time.perf_counter()
        image_items: List[Tuple[int, Prepped]] = []
        text_items: List[Tuple[int, str]] = []
        for i, chunk in enumerate(chunks):
            if not chunk.metadata.get("is_image"):
                text_items.append((i, chunk.content))
                continue
            pp = chunk.metadata.pop("_patches", None)
            coeffs = chunk.metadata.pop("_jpeg", None)
            if pp is None:
                # the decoded payload, as the reference embeds it: the
                # coefficients of the port's own JPEG, else the bytes
                page = (decode_own(coeffs) if coeffs is not None
                        else decode_image(data_uri_to_bytes(chunk.content), self.device))
                pp = preprocess_array_u8(page, min_pixels=self.min_pixels, max_pixels=self.max_pixels)
            image_items.append((i, (pp[0], tuple(pp[1]))))
        prep_s = time.perf_counter() - t0
        results: List[Optional[np.ndarray]] = [None] * len(chunks)
        fde_out: List[Optional[np.ndarray]] = [None] * len(chunks)
        if image_items:
            embs, fdes = self._embed_prepped([pp for _, pp in image_items], with_fde=True, prep_s=prep_s)
            for (i, _), e, f in zip(image_items, embs, fdes):
                results[i], fde_out[i] = e, f
        if text_items:
            for (i, _), e in zip(text_items, self.embed_texts([t for _, t in text_items])):
                results[i] = e
        self.last_metrics["total_s"] = time.perf_counter() - t0
        return results, fde_out

    async def embed_for_ingestion(self, chunks: Union[Chunk, List[Chunk]]) -> List[np.ndarray]:
        return self.embed_for_ingestion_sync(chunks)[0]

    def warmup(self, grids: Optional[List[Tuple[int, int]]] = None) -> float:
        """Run the query path and the page-grid forwards once. Errors
        propagate: a model that cannot warm up cannot serve."""
        t0 = time.perf_counter()
        self.embed_texts(["warmup query"])
        for hu, wu in grids or [(20, 28)]:
            s = hu * wu * self.model.cfg.vision.merge_unit
            patches = np.zeros((1, s, self.model.cfg.vision.patch_input_dim // 2), np.uint8)
            self.model.embed_image_batch(patches, hu, wu)
        dt = time.perf_counter() - t0
        logger.info("warmup done in %.1fs", dt)
        return dt
