"""Device probe and numeric flags for the port.

Twin of `morphik_core_tpu/ops/maxsim.py::default_use_pallas`: the
hand-written kernels exist for Hopper only, so "kernels available" means
a CUDA device of compute capability (9, 0).

TF32 is switched off once, here, for every module of the port. A float32
matmul on the card then runs in full float32 (PyTorch's default for
matmuls, but not for cuDNN convolutions), which matters twice:
- the plain int8 dots (`int8.float() @ int8.float()`) are exact only
  when every product and partial sum is a float32 integer, and TF32
  keeps 10 mantissa bits;
- the float32 parity runs compare against the JAX reference at 2e-4,
  which TF32's ~1e-3 relative error would swamp.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def kernels_available() -> bool:
    """True when a Hopper (sm_90) CUDA device is present."""
    return torch.cuda.is_available() and torch.cuda.get_device_capability(0) == (9, 0)


def default_device() -> torch.device:
    """The card. Without one this raises: the port's entry points never
    carry on on the CPU unless the caller asks for it with `device="cpu"`
    (as the CPU tests do)."""
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device found; pass device="cpu" to run on the CPU')
    return torch.device("cuda")
