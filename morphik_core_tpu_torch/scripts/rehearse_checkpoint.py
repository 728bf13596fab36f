"""Full-scale checkpoint load rehearsal, PyTorch port of
`scripts/rehearse_checkpoint.py`.

Writes a random ColQwen2.5-3B checkpoint in the HF format the released
`tsystems/colqwen2.5-3b-multilingual-v1.0` ships (sharded bf16
safetensors in colpali_engine's names, `model.safetensors.index.json`,
`config.json`), then rehearses the production boot on the card:
`ColQwenModel.from_checkpoint`, then one serving step, reporting each
phase's seconds and the peak host RSS of the load. Then the two load
failure modes at the tiny geometry: a checkpoint without
`custom_text_proj` is rejected, and a float32-stored one loads as bf16.
Prints one JSON report.

    python -m morphik_core_tpu_torch.scripts.rehearse_checkpoint [--dir DIR]
        [--small] [--keep] [--skip-write] [--device cpu]

`--small` takes the tiny geometry (seconds); the default is the 3B
geometry on the card (~7.5 GB on disk). No package beyond torch and
numpy is needed: the port reads and writes safetensors itself.
"""

from __future__ import annotations

import argparse
import json
import resource
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
from morphik_core_tpu_torch.models.colqwen.convert import hf_config_dict, hf_tensors, write_hf_checkpoint
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel
from morphik_core_tpu_torch.models.colqwen.safetensors import save_file

SHARD_BYTES = 2 * 1024**3  # the released checkpoints' shard size


def reset_peak_rss() -> None:
    """Start a new peak-RSS window (Linux: /proc/self/clear_refs "5")."""
    try:
        Path("/proc/self/clear_refs").write_text("5")
    except OSError:
        pass  # peak_rss_gb then reports the process's lifetime peak


def _status_gb(key: str):
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith(key + ":"):
                return int(line.split()[1]) / 1024**2  # kB
    except OSError:
        pass
    return None


def peak_rss_gb() -> float:
    """The host RSS high-water mark since `reset_peak_rss` (GiB)."""
    peak = _status_gb("VmHWM")
    return peak if peak is not None else resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024**2


def rss_gb() -> float:
    """The host RSS now (GiB; 0 where /proc is not there)."""
    return _status_gb("VmRSS") or 0.0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def write_checkpoint(cfg: ColQwenConfig, out_dir, device, shard_bytes: int = SHARD_BYTES, seed: int = 0,
                     tokenizer_file=None) -> dict:
    """A random bf16 model of geometry `cfg` (the reference's init law,
    drawn on `device`), written as an HF checkpoint directory."""
    t0 = time.perf_counter()
    model = ColQwenModel.init_random(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    _sync(device)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = write_hf_checkpoint(model, out_dir, shard_bytes=shard_bytes, tokenizer_file=tokenizer_file)
    write_s = time.perf_counter() - t0
    return dict(stats, init_s=init_s, write_s=write_s, gb=stats["bytes"] / 1e9)


def rehearse_load(ckpt_dir, device, grid=(20, 28), batch: int = 8, **precisions) -> dict:
    """Boot `from_checkpoint` on `device` and run one serving step twice."""
    reset_peak_rss()
    stats = {"rss_before_gb": rss_gb()}
    t0 = time.perf_counter()
    model = ColQwenModel.from_checkpoint(ckpt_dir, device=device, **precisions)
    _sync(device)
    stats["load_s"] = time.perf_counter() - t0  # read + convert + upload
    stats["peak_rss_gb"] = peak_rss_gb()
    stats["n_params"] = sum(p.numel() for p in model.parameters())
    hu, wu = grid
    patches = np.zeros((batch, hu * wu * model.cfg.vision.merge_unit, model.cfg.vision.patch_input_dim // 2), np.uint8)
    t0 = time.perf_counter()
    model.embed_image_batch(patches, hu, wu)
    stats["first_step_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    embs = model.embed_image_batch(patches, hu, wu)
    stats["steady_step_ms"] = (time.perf_counter() - t0) * 1e3
    stats["emb_shape"] = list(embs.shape)
    if not np.isfinite(embs).all():
        raise AssertionError("non-finite embeddings")
    return stats


def rehearse_failure_modes(tmp_dir) -> dict:
    """At the tiny geometry on the CPU, through `from_checkpoint` as a
    server boots: (a) a checkpoint without custom_text_proj (a base
    Qwen2.5-VL) is rejected; (b) a float32-stored one loads as bf16."""
    tmp_dir = Path(tmp_dir)
    cfg = ColQwenConfig.tiny()
    model = ColQwenModel.init_random(cfg, seed=1, device="cpu", dtype=torch.float32)
    state = {name: fn() for name, _, fn in hf_tensors(model)}
    for name, tensors in (("no_proj", {k: v for k, v in state.items() if not k.startswith("custom_text_proj")}),
                          ("f32", state)):
        (tmp_dir / name).mkdir(parents=True, exist_ok=True)
        save_file(tensors, tmp_dir / name / "model.safetensors")
        (tmp_dir / name / "config.json").write_text(json.dumps(hf_config_dict(cfg)))
    try:
        ColQwenModel.from_checkpoint(tmp_dir / "no_proj", device="cpu")
        rejected = False
    except KeyError as e:
        rejected = "custom_text_proj" in str(e)
    loaded = ColQwenModel.from_checkpoint(tmp_dir / "f32", dtype=torch.bfloat16, device="cpu")
    f32_ok = loaded.proj_w.dtype == torch.bfloat16 and torch.equal(
        loaded.proj_w.detach(), model.proj_w.detach().to(torch.bfloat16))
    return {"missing_proj_rejected": rejected, "f32_checkpoint_converts": bool(f32_ok)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=None, help="checkpoint directory (default: a new temporary one)")
    ap.add_argument("--small", action="store_true", help="tiny geometry")
    ap.add_argument("--skip-write", action="store_true", help="reuse an existing --dir")
    ap.add_argument("--keep", action="store_true", help="do not delete the checkpoint")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from morphik_core_tpu_torch.device import default_device

    device = torch.device(args.device) if args.device else default_device()
    cfg = ColQwenConfig.tiny() if args.small else ColQwenConfig()
    out = Path(args.dir) if args.dir else Path(tempfile.mkdtemp(prefix="ckpt_rehearsal_"))
    report = {"geometry": "tiny" if args.small else "3b", "device": str(device)}
    if device.type == "cuda":
        report["card"] = torch.cuda.get_device_name(0)
    try:
        if not args.skip_write:
            report["write"] = write_checkpoint(cfg, out, device, shard_bytes=(1 << 20) if args.small else SHARD_BYTES)
        grid, batch = ((4, 4), 2) if args.small else ((20, 28), 8)
        report["load"] = rehearse_load(out, device, grid=grid, batch=batch)
        report["failure_modes"] = rehearse_failure_modes(out / "_failures")
    finally:
        if not args.keep:
            shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(report))
    return 0 if all(report["failure_modes"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
