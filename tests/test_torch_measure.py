"""The port's two measuring scripts, `scripts/profile_int8.py` and
`scripts/bench_ingest.py`, run `--small --cpu`: their reports carry the
keys of the originals' committed reports (`PROFILE_r04.json`,
`INGEST_r05.json`), bar the TPU ratio `vs_chip_north_star`, and their
numbers are finite and consistent. Neither writes a file without `--out`.
The card's numbers come from their runs on the card."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from morphik_core_tpu_torch.scripts import bench_ingest, profile_int8

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _keys(d: dict) -> set:
    return set(d)


def _run(main, argv, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert list(tmp_path.iterdir()) == [] or all(p.name.startswith("trace") for p in tmp_path.iterdir())
    return json.loads(out)


def test_profile_int8_small_keys(capsys, tmp_path, monkeypatch):
    rep = _run(profile_int8.main, ["--small", "--cpu", "--trace-dir", str(tmp_path / "trace")], capsys, tmp_path,
               monkeypatch)
    ref = json.loads((ROOT / "PROFILE_r04.json").read_text())
    assert _keys(ref) <= _keys(rep)
    assert _keys(ref["derived"]) <= _keys(rep["derived"])
    assert _keys(rep["matmul_families"]) == _keys(ref["matmul_families"])
    fam_keys = _keys(next(iter(ref["matmul_families"].values())))
    for name, fam in rep["matmul_families"].items():
        assert fam_keys <= _keys(fam), name
        assert all(fam[k] > 0 for k in ("per_call_bf16_ms", "per_call_q8_ms", "per_call_q8_prequant_ms")), name
    assert rep["s_text"] == 3 + rep["grid"][0] * rep["grid"][1] + 2  # the original's image-step sequence
    assert rep["derived"]["dyn_quant_cost_ms"] == pytest.approx(
        rep["derived"]["step_sum_matmul_q8_ms"] - rep["derived"]["step_sum_matmul_q8_prequant_ms"], abs=0.2)
    assert set(rep["timing"].values()) == {"host_clock"}
    prof = rep["int8_batch_profile"]
    assert Path(prof["trace"]).exists() and prof["trace_bytes"] > 0
    assert prof["device_events"] == 0 and prof["idle_share"] is None  # no device on the CPU


def test_idle_share_of_a_trace():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 25.0, "dur": 10.0},  # overlaps a
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 60.0, "dur": 50.0},  # past the window's end
        {"ph": "X", "cat": "cpu_op", "name": "d", "ts": 0.0, "dur": 100.0},
    ]}
    got = profile_int8._idle_share(trace, (0.0, 100.0))
    assert got["busy_us"] == 25.0 + 40.0 and got["device_events"] == 3
    assert got["idle_share"] == pytest.approx(0.35)


def test_bench_ingest_small_keys(capsys, tmp_path, monkeypatch):
    rep = _run(bench_ingest.main, ["--small", "--cpu"], capsys, tmp_path, monkeypatch)
    ref = json.loads((ROOT / "INGEST_r05.json").read_text())
    assert _keys(ref) - {"vs_chip_north_star"} <= _keys(rep) and "vs_chip_north_star" not in rep
    for key in ("embed_attribution", "stage_isolation_pages_per_s"):
        assert _keys(rep[key]) == _keys(ref[key]), key
    assert _keys(rep["raster_pool_scaling"]) == {"host_cpus", "pages", "procs_1_pages_per_s", "procs_2_pages_per_s"}
    assert rep["pages"] == 12 and rep["docs"] == 3 and rep["backend"] == "cpu" and rep["small"] is True
    assert rep["max_jobs"] >= 1 and f"max_jobs={rep['max_jobs']}" in rep["metric"]
    values = [rep["value"], *rep["stage_isolation_pages_per_s"].values()]
    assert all(math.isfinite(v) and v > 0 for v in values)
    assert set(rep["phase_split_s"]) >= {"rasterize", "embed_store"}
    assert np.isclose(rep["phase_sum_s"], sum(rep["phase_split_s"].values()), atol=0.05)
