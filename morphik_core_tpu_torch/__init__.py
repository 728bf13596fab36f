"""PyTorch + CUDA port of the morphik-core-tpu ColPali ingest -> retrieve
slice, for NVIDIA Hopper (sm_90a).

The JAX package `morphik_core_tpu` is the reference. This package
mirrors its layout (`ops/`, `parallel/`, `models/colqwen/`,
`embedding/`, `index/`) and imports neither jax, PIL (outside the
functions that decode images) nor pydantic: every numpy helper it
needs is mirrored here, and tests hold each mirror bit-identical to its
original. The MaxSim kernels live in `csrc/maxsim.cu`.
"""
