"""PyTorch + CUDA port of the morphik-core-tpu ColPali ingest -> retrieve
slice, for NVIDIA Hopper (sm_90a), with its HTTP service plane.

The JAX package `morphik_core_tpu` is the reference. This package
mirrors its layout (`ops/`, `parallel/`, `models/colqwen/`,
`embedding/`, `index/`, and the service plane: `config.py`,
`models/schemas.py`, `storage/`, `database/`, `vector_store/`,
`completion/`, `workers/`, `services/`, `services_init.py`, `api/`) and
imports neither jax, PIL (outside the functions that take a PIL image)
nor pydantic: every helper it needs is mirrored or copied here, and
tests hold each mirror to its original. The kernels live in `csrc/`.
"""

__version__ = "0.1.0"
