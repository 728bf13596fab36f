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
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from morphik_core_tpu_torch.models.colqwen.calibrate import calibration_batches, load_calibration_pages
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel
from morphik_core_tpu_torch.models.colqwen.preprocess import preprocess_image_u8
from morphik_core_tpu_torch.ops.fde import FDEConfig, fde_document_batch

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

    @property
    def embedding_dim(self) -> int:
        return self.model.cfg.embedding_dim

    def prep_images(self, images: Sequence["object"]) -> List[Prepped]:
        """PIL images -> (uint8 patches (S, 588), grid) pairs."""
        return [
            preprocess_image_u8(im, min_pixels=self.min_pixels, max_pixels=self.max_pixels)
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

    def embed_for_query(self, query: Union[str, "object"]) -> np.ndarray:
        """Text query or PIL image query -> (n_tokens, dim) f32."""
        if isinstance(query, str):
            return self.embed_texts([query])[0]
        return self.embed_images([query])[0]

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
