"""Device mesh, PyTorch port of `morphik_core_tpu/parallel/mesh.py`.

The engine scales over a (data, model) mesh of cards:
  - axis "data":  data-parallel over pages and over index rows;
  - axis "model": tensor-parallel over the text decoder's hidden dims.

Single host, single controller: one Python process drives every card of
the mesh, as one JAX process drives every chip of a `jax.sharding.Mesh`
under `shard_map`. No `torch.distributed` process group is involved; the
collectives (`parallel/collectives.py`) are peer copies. A mesh's devices
may repeat (`make_mesh((2, 2), devices=["cuda:0"] * 4)`): every shard then
runs on that one card, which exercises all the shard math without a
second card, as the JAX tests' virtual CPU devices do. The multi-host
case (one process per host) is not ported (ROADMAP Queue 1 item 6c).

Placement: a data-sharded tensor is a list of per-shard tensors, shard d
on the first device of data row d; a replicated tensor or module is one
object per distinct device, the original where it already lives (a
repeated device holds one tensor, not a copy).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: the mesh's axes: data-parallel over pages and index rows, tensor-parallel
#: over the text decoder (the reference's `tpu.mesh_axis_names` default;
#: the port serves no other names)
AXES = ("data", "model")

#: the text decoder's tensor-parallel leaves (`shard_colqwen_params`):
#: "columns" splits a (K, N) weight's output columns over the model axis,
#: "rows" its input rows; every other leaf is replicated
COLQWEN_TEXT_SPECS = {
    "gate_w": "columns", "up_w": "columns", "down_w": "rows",
    "q_w": "columns", "k_w": "columns", "v_w": "columns", "o_w": "rows",
}


def normalize_device(d) -> torch.device:
    """`d` as a torch.device with its index ("cuda" -> "cuda:<current>")."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def check_axis_names(axis_names: Sequence[str]) -> None:
    """Raise unless `axis_names` is ("data", "model")."""
    if tuple(axis_names) != AXES:
        raise ValueError(f"mesh axes {tuple(axis_names)}: the port serves {AXES} only")


class Mesh:
    """An ndarray of `torch.device` shaped (data, model). `shape` is a
    dict (axis -> size), as `jax.sharding.Mesh`'s."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"{devices.ndim}-d devices for axes {AXES}")
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def n_data(self) -> int:
        return self.devices.shape[0]

    @property
    def n_model(self) -> int:
        return self.devices.shape[1]

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def data_devices(self) -> List[torch.device]:
        """The first device of each data row, in data-axis order (where a
        data shard lives)."""
        return list(self.devices[:, 0])

    def row(self, d: int) -> List[torch.device]:
        """The devices of data row `d`, in model-axis order."""
        return list(self.devices[d])

    def row_leads(self) -> List[torch.device]:
        """The distinct first devices of the data rows (where a row's
        replicated leaves and residual stream live)."""
        return list(dict.fromkeys(self.data_devices()))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def local_device_count() -> int:
    return torch.cuda.device_count()


def process_count() -> int:
    """Processes of the job: `torch.distributed`'s world size when a group
    is up, else 1."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(shape: Sequence[int], axis_names: Sequence[str] = AXES,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of the given logical shape over `devices` (default: every
    visible card, in index order; an explicit list may repeat an entry). A
    single -1 entry is inferred from the device count, as in a reshape.
    Axis names other than ("data", "model") raise."""
    check_axis_names(axis_names)
    devs = [torch.device("cuda", i) for i in range(local_device_count())] if devices is None \
        else [normalize_device(d) for d in devices]
    n = len(devs)
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError("at most one -1 axis")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by {known}")
        shape[shape.index(-1)] = n // known
    total = int(np.prod(shape))
    if total > n:
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {n}")
    arr = np.empty(total, dtype=object)
    arr[:] = devs[:total]
    return Mesh(arr.reshape(shape))


def best_mesh(model_parallel: int = 1) -> Mesh:
    """Default mesh: every card data-parallel, with an optional model axis.
    One host only: a job of several processes (one a host) raises."""
    if process_count() > 1:
        raise NotImplementedError(
            "not ported: a mesh across hosts, one process a host over torch.distributed "
            "(ROADMAP Queue 1 item 6c)")
    return make_mesh((-1, model_parallel))


def _device_of(x) -> torch.device:
    if isinstance(x, torch.Tensor):
        return x.device
    return next(t.device for t in (*x.parameters(), *x.buffers()))


def _copy_to(x, device: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return copy.deepcopy(x).to(device)


def replicated(mesh: Mesh, x) -> Dict[torch.device, object]:
    """`x` (a tensor or a module) once on the first device of each data
    row (`Mesh.row_leads`); `x` itself where it lives."""
    home = _device_of(x)
    return {d: x if d == home else _copy_to(x, d) for d in mesh.row_leads()}


def data_sharding(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """`x` split along its leading axis over the data axis: shard d on the
    first device of data row d (the rest of the row reads it by copy)."""
    devs = mesh.data_devices()
    if x.shape[0] % len(devs):
        raise ValueError(f"leading axis {x.shape[0]} not divisible by mesh data axis {len(devs)}")
    n = x.shape[0] // len(devs)
    return [x[i * n : (i + 1) * n].to(d) for i, d in enumerate(devs)]


def text_shard_ranges(cfg, m: int, j: int) -> Dict[str, Tuple[int, int]]:
    """The [lo, hi) slice of each tensor-parallel leaf (`COLQWEN_TEXT_SPECS`)
    held by model shard j of m, on the axis its spec splits.

    Attention splits by query heads: shard j takes heads [j nh/m, (j+1)
    nh/m) (q_w's columns, o_w's rows). k_w / v_w give it the whole KV heads
    those query heads read (head h reads KV head h // (nh / nkv)): with m >
    nkv two shards hold the same columns, and a head is never split. The
    MLP splits the intermediate dim evenly."""
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if nh % m or cfg.intermediate_size % m or nh % nkv:
        raise ValueError(f"model axis {m} must divide {nh} heads and intermediate {cfg.intermediate_size}")
    per, group, ip = nh // m, nh // nkv, cfg.intermediate_size // m
    h0, h1 = j * per, (j + 1) * per
    kv0, kv1 = h0 // group, (h1 - 1) // group + 1
    q, kv, mlp = (h0 * hd, h1 * hd), (kv0 * hd, kv1 * hd), (j * ip, (j + 1) * ip)
    return {"q_w": q, "k_w": kv, "v_w": kv, "o_w": q, "gate_w": mlp, "up_w": mlp, "down_w": mlp}


def shard_colqwen_params(model, mesh: Mesh):
    """Place a filled ColQwen model on `mesh`, in place (after any int8
    quantization, as the reference shards its quantized tree): the text
    decoder's q/k/v/gate/up split by columns and o/down by rows over the
    model axis (`text_shard_ranges`; a W8A8 leaf's int8 weight follows
    its weight, its per-channel scales the output channels, its static
    scale is replicated), everything else replicated over the first device
    of each data row. Returns the model."""
    if model.mesh is not None:
        raise ValueError("the model is already on a mesh")
    if normalize_device(model.device) != mesh.first_device:
        raise ValueError(f"the model is on {model.device}, the mesh starts at {mesh.first_device}")
    model.text.shard(mesh)
    model.mesh, model.device = mesh, mesh.first_device
    model.place_replicas()
    return model

