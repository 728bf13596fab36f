#!/usr/bin/env python3
"""Where the int8 (W8A8) image step's time goes on the card: twin of
`scripts/profile_int8.py` at the same 3B shapes (batch 8, grid 20 x 28),
with its report keys.

It times:
  - the whole image step, bf16 and int8 (dynamic activation scales, as
    the original's `quantize_colqwen_params`), and the vision tower and
    the text stack alone, each in both;
  - attention alone at the model's shapes: K3 in the windowed vision
    blocks, the plain einsum attention in the full ones and in the text
    stack;
  - each matmul family at its shapes three ways: bf16 (`torch.matmul`),
    q8 (the port's `q8_matmul`: dynamic activation quantization, the
    exact int8 product, the dequantization) and q8_prequant (the
    activations already quantized). The q8 - q8_prequant gap is the
    quantization's cost.
On the card each time is CUDA events around replays of a CUDA graph of
the calls (the original's fori_loop N-vs-2N chains do not port), best of
three; with `--cpu` it is the host clock around the calls. Peak rates
are one H100 SXM's dense figures (int8 1,979 TOP/s, bf16 989 TFLOP/s).

It also records one `torch.profiler` trace of an 8-page int8 batch at
grid 20 x 28 (`--trace-dir`, default a new temporary directory) and
prints the device's idle share within the batch: 1 - (the union of the
kernels' and copies' intervals) / (the batch's span on the host clock,
which ends with the embeddings' copy to the host).

    python -m morphik_core_tpu_torch.scripts.profile_int8 [--out PROFILE.json] [--trace-dir DIR]
        [--small] [--cpu]

`--small` runs the tiny geometry (batch 1, grid 4 x 4). It writes a file
only with `--out` (the original writes PROFILE_r04.json at the repo root).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

PEAK_INT8_TOPS = 1979.0
PEAK_BF16_TFLOPS = 989.0


def _randn(torch, gen, *shape):
    """Seeded bf16 normals on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device).to(torch.bfloat16)


def _time_ms(torch, device, fn: Callable, iters: int) -> Tuple[float, str]:
    """-> (ms per call, method): best of three timings of `iters` calls,
    without autograd."""
    with torch.no_grad():
        return _time_calls(torch, device, fn, iters)


def _time_calls(torch, device, fn: Callable, iters: int) -> Tuple[float, str]:
    fn()  # warm: kernel builds, allocator
    if device.type == "cuda":
        torch.cuda.synchronize()
        try:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                fn()
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(iters):
                    fn()
            run, method = graph.replay, "cuda_graph"
        except Exception:  # noqa: BLE001 - a call that cannot be captured is timed eagerly
            torch.cuda.synchronize()

            def run():
                for _ in range(iters):
                    fn()
            method = "eager_events"
        best = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            best.append(start.elapsed_time(end) / iters)
        del run
        return min(best), method
    best = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best.append((time.perf_counter() - t0) * 1e3 / iters)
    return min(best), "host_clock"


def _idle_share(trace: dict, span: Tuple[float, float]) -> dict:
    """The device's idle share within `span` (us on the trace's clock):
    1 - union(kernel, memcpy, memset intervals) / span."""
    lo, hi = span
    busy = sorted((max(e["ts"], lo), min(e["ts"] + e.get("dur", 0), hi)) for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and e["ts"] < hi and e["ts"] + e.get("dur", 0) > lo)
    total, cur_lo, cur_hi, n = 0.0, None, None, len(busy)
    for a, b in busy:
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    window = hi - lo
    return {"window_us": window, "busy_us": total, "device_events": n,
            "idle_share": (1.0 - total / window) if window > 0 and n else None}


def trace_int8_batch(torch, model, patches_u8: np.ndarray, hu: int, wu: int, trace_dir: Path) -> dict:
    """One profiled `embed_image_batch` of the int8 model -> the trace's
    path, its kernels' top device times and the device idle share."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if model.device.type == "cuda" else [])
    model.embed_image_batch(patches_u8, hu, wu)  # warm
    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / "int8_batch_trace.json"
    with profile(activities=activities) as prof:
        with record_function("int8_batch"):
            model.embed_image_batch(patches_u8, hu, wu)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    mark = next(e for e in trace["traceEvents"] if e.get("name") == "int8_batch" and e.get("ph") == "X"
                and e.get("cat") == "user_annotation")
    out = {"trace": str(path), "trace_bytes": path.stat().st_size}
    out.update(_idle_share(trace, (mark["ts"], mark["ts"] + mark["dur"])))
    kernels: Dict[str, float] = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + e.get("dur", 0.0)
    out["top_kernels_us"] = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    return out


def matmul_families(torch, device, cfg, m_vis: int, m_txt: int, methods: Dict[str, str]) -> dict:
    """Each matmul family of the step at its shapes (`m_vis` vision rows,
    `m_txt` text rows): bf16, q8 and q8 with the activations quantized
    beforehand, per call and per step."""
    from morphik_core_tpu_torch.models.colqwen.layers import (
        QuantizedWeight,
        _dequant,
        int8_dot,
        q8_matmul,
        quantize_act_int8,
    )

    gen = torch.Generator(device=device)
    gen.manual_seed(11)

    nkv, hdt = cfg.text.num_key_value_heads, cfg.text.head_dim
    vh, vi = cfg.vision.hidden_size, cfg.vision.intermediate_size
    th, ti = cfg.text.hidden_size, cfg.text.intermediate_size
    shapes = {
        "vis_qkv_proj": (m_vis, vh, vh, 4 * cfg.vision.depth),
        "vis_gateup": (m_vis, vh, vi, 2 * cfg.vision.depth),
        "vis_down": (m_vis, vi, vh, cfg.vision.depth),
        "txt_qo": (m_txt, th, th, 2 * cfg.text.num_hidden_layers),
        "txt_kv": (m_txt, th, nkv * hdt, 2 * cfg.text.num_hidden_layers),
        "txt_gateup": (m_txt, th, ti, 2 * cfg.text.num_hidden_layers),
        "txt_down": (m_txt, ti, th, cfg.text.num_hidden_layers),
    }
    fam = {}
    for name, (m, k_dim, n_dim, count) in shapes.items():
        x, w = _randn(torch, gen, m, k_dim), _randn(torch, gen, k_dim, n_dim)
        wq = QuantizedWeight.from_float(w)
        xq, xs = quantize_act_int8(x)
        iters = 16 if m * k_dim * n_dim < 2e11 else 8
        t_bf16, methods[f"{name}_bf16"] = _time_ms(torch, device, lambda: x @ w, iters)
        t_q8, methods[f"{name}_q8"] = _time_ms(torch, device, lambda: q8_matmul(x, wq), iters)
        t_q8p, methods[f"{name}_q8_prequant"] = _time_ms(
            torch, device, lambda: _dequant(int8_dot(xq, wq), xs, wq, None, x.dtype), iters)
        ops = 2 * m * k_dim * n_dim
        fam[name] = {
            "shape": [m, k_dim, n_dim],
            "per_call_bf16_ms": round(t_bf16, 3),
            "per_call_q8_ms": round(t_q8, 3),
            "per_call_q8_prequant_ms": round(t_q8p, 3),
            "count_per_step": count,
            "step_bf16_ms": round(t_bf16 * count, 2),
            "step_q8_ms": round(t_q8 * count, 2),
            "step_q8_prequant_ms": round(t_q8p * count, 2),
            "bf16_tflops": round(ops / (t_bf16 / 1e3) / 1e12, 1),
            "q8_tops": round(ops / (t_q8 / 1e3) / 1e12, 1),
            "q8_prequant_tops": round(ops / (t_q8p / 1e3) / 1e12, 1),
            "bf16_share_of_peak": round(ops / (t_bf16 / 1e3) / 1e12 / PEAK_BF16_TFLOPS, 4),
            "q8_prequant_share_of_peak": round(ops / (t_q8p / 1e3) / 1e12 / PEAK_INT8_TOPS, 4),
        }
        del x, w, wq, xq, xs
    return fam


def run(small: bool, device=None, trace_dir: Path = None) -> dict:
    import torch

    from morphik_core_tpu_torch.device import default_device
    from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
    from morphik_core_tpu_torch.models.colqwen.layers import attention
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel, quantize_colqwen_params
    from morphik_core_tpu_torch.models.colqwen.text import mrope_cos_sin, mrope_position_ids
    from morphik_core_tpu_torch.models.colqwen.vision import vision_rotary_cos_sin
    from morphik_core_tpu_torch.ops.window_attention import window_attention

    device = torch.device(device) if device is not None else default_device()
    cfg = ColQwenConfig.tiny() if small else ColQwenConfig()
    B, HU, WU = (1, 4, 4) if small else (8, 20, 28)
    S_p = HU * WU * cfg.vision.merge_unit  # patches
    n_units = HU * WU
    gen = torch.Generator(device=device)
    gen.manual_seed(5)

    def randn(*shape):
        return _randn(torch, gen, *shape)

    def timed(fn, iters):
        return _time_ms(torch, device, fn, iters)

    model = ColQwenModel.init_random(cfg, seed=0, device=device, dtype=torch.bfloat16)
    # the original's image-step sequence: two text ids, the image run, one more
    ids = np.array([7, 8, cfg.vision_start_token_id] + [cfg.image_token_id] * n_units
                   + [cfg.vision_end_token_id, 9], np.int64)
    S_t = len(ids)
    rep: dict = {"batch": B, "grid": [HU, WU], "s_patches": S_p, "s_text": S_t, "device": str(device),
                 "geometry": "tiny" if small else "3b"}
    methods: Dict[str, str] = {}

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    patches_u8 = np.random.default_rng(5).integers(0, 256, (B, S_p, 588), dtype=np.uint8)
    patches = randn(B, S_p, cfg.vision.patch_input_dim)
    cos_v, sin_v = (dev(x) for x in vision_rotary_cos_sin(HU, WU, cfg.vision))
    input_ids = np.tile(ids[None], (B, 1))
    pos = mrope_position_ids(input_ids, cfg.image_token_id, [(1, HU, WU)] * B)
    cos_t, sin_t = (dev(x) for x in mrope_cos_sin(pos, cfg.text))
    input_ids_d = dev(input_ids)
    embeds = randn(B, S_t, cfg.text.hidden_size)
    tmask = torch.ones((B, S_t), dtype=torch.float32, device=device)
    steps = {
        "full": lambda: model.image_forward(patches, cos_v, sin_v, input_ids_d, cos_t, sin_t, HU, WU),
        "vision": lambda: model.visual(patches, cos_v, sin_v, HU, WU),
        "text": lambda: model.text(embeds, cos_t, sin_t, tmask),
    }
    for mode in ("bf16", "int8"):
        if mode == "int8":
            quantize_colqwen_params(model)
        for name, fn in steps.items():
            rep[f"{name}_{mode}_ms"], methods[f"{name}_{mode}"] = timed(fn, 2)

    # ---- attention alone (stays bf16 in both modes) --------------------------
    nhv, hdv = cfg.vision.num_heads, cfg.vision.head_dim
    win = cfg.vision.window_units**2 * cfg.vision.merge_unit
    qv = randn(B * S_p, nhv, hdv)
    per_win, methods["vision_attn_window"] = timed(lambda: window_attention(qv, qv, qv, window=win), 16)
    qf = randn(B, S_p, nhv, hdv)
    per_full, methods["vision_attn_full"] = timed(lambda: attention(qf, qf, qf), 4)
    n_full = len(cfg.vision.fullatt_block_indexes)
    rep["vision_attn_ms"] = per_win * (cfg.vision.depth - n_full) + per_full * n_full
    rep["vision_attn_window_per_block_ms"], rep["vision_attn_full_per_block_ms"] = per_win, per_full
    nht, nkv, hdt = cfg.text.num_attention_heads, cfg.text.num_key_value_heads, cfg.text.head_dim
    qt, kt = randn(B, S_t, nht, hdt), randn(B, S_t, nkv, hdt)
    causal = torch.tril(torch.ones((S_t, S_t), dtype=torch.bool, device=device))
    bias = torch.where(causal[None, None], 0.0, -1e30).float()
    per_text, methods["text_attn"] = timed(lambda: attention(qt, kt, kt, bias=bias), 8)
    rep["text_attn_ms"] = per_text * cfg.text.num_hidden_layers

    # ---- matmul families: bf16 vs q8 vs q8 with pre-quantized activations ---
    fam = matmul_families(torch, device, cfg, B * S_p, B * S_t, methods)
    rep["matmul_families"] = fam
    rep["derived"] = {
        "step_sum_matmul_bf16_ms": round(sum(f["step_bf16_ms"] for f in fam.values()), 1),
        "step_sum_matmul_q8_ms": round(sum(f["step_q8_ms"] for f in fam.values()), 1),
        "step_sum_matmul_q8_prequant_ms": round(sum(f["step_q8_prequant_ms"] for f in fam.values()), 1),
        "dyn_quant_cost_ms": round(sum(f["step_q8_ms"] - f["step_q8_prequant_ms"] for f in fam.values()), 1),
        "attn_total_ms": round(rep["vision_attn_ms"] + rep["text_attn_ms"], 1),
    }
    for k in ("full_bf16_ms", "full_int8_ms", "vision_bf16_ms", "vision_int8_ms",
              "text_bf16_ms", "text_int8_ms", "vision_attn_ms", "text_attn_ms"):
        rep[k] = round(rep[k], 2)
    rep["timing"] = methods
    rep["peak_rates"] = {"int8_tops": PEAK_INT8_TOPS, "bf16_tflops": PEAK_BF16_TFLOPS,
                         "source": "H100 SXM dense tensor-core figures"}
    trace_dir = Path(trace_dir) if trace_dir else Path(tempfile.mkdtemp(prefix="profile_int8_"))
    rep["int8_batch_profile"] = trace_int8_batch(torch, model, patches_u8, HU, WU, trace_dir)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--small", action="store_true", help="the tiny geometry (batch 1, grid 4 x 4)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--out", type=Path, default=None, help="write the report here too")
    ap.add_argument("--trace-dir", type=Path, default=None, help="where the int8 batch's trace goes")
    args = ap.parse_args(argv)
    rep = run(args.small, "cpu" if args.cpu else None, args.trace_dir)
    if args.out:
        args.out.write_text(json.dumps(rep, indent=1))
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
