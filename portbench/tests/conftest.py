"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout with a TINY cell added by files and entries alone, as a
later change would add one."""

from __future__ import annotations

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CELL = "tiny_vol3d"
TINY_SIZE = 128


def tiny_model(compute_dtype: str = "float32") -> dict:
    from medsam2_tpu_torch.configs import get_config

    cfg = get_config("sam2_hiera_s", image_size=TINY_SIZE, compute_dtype=compute_dtype)
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def add_tiny_cell(root: Path, limits: dict, compute_dtype: str = "float32") -> None:
    """Add the TINY configuration, traffic mix, limits, a throwaway per-layer
    metric with its reader, and the cell, to the checkout at ``root``."""
    pb = root / "portbench"
    doc = json.loads((pb / "configs" / "sam2_hiera_s_1024.json").read_text())
    doc.update(name="tiny_s128", model=tiny_model(compute_dtype),
               overrides={"image_size": TINY_SIZE, "compute_dtype": compute_dtype})
    (pb / "configs" / "tiny_s128.json").write_text(json.dumps(doc))
    tr = json.loads((pb / "traffic" / "vol3d_v4x32.json").read_text())
    tr.update(volumes_per_call=2, slices=5, pool=3)
    (pb / "traffic" / "tiny_vol.json").write_text(json.dumps(tr))
    (pb / "limits" / f"{TINY_CELL}.json").write_text(json.dumps(limits))
    (pb / "layer_metrics" / "tinyprobe.py").write_text(
        "def read(ctx):\n    return float(ctx['window'].units)\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_s128", "source": "https://example.org/tiny",
                         "file": "portbench/configs/tiny_s128.json",
                         "reduced": ["image_size"], "why": "CPU tests"})
    b["workloads"].append({"name": TINY_CELL, "config": "tiny_s128", "traffic": "tiny_vol",
                           "chips": 1, "why": "CPU tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and m["name"] in ("slices_per_s", "mfu.vol3d",
                                              "launches_per_slice.vol3d"):
            m["workloads"].append(TINY_CELL)
    b["per_layer"].append({"name": "tinyprobe.units", "unit": "units", "better": "higher",
                           "source": "host_clock", "layer": "session loop",
                           "moves": "slices_per_s", "workloads": [TINY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def copy_benchmark(dst: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def real_limits() -> dict:
    """The full-size cell's limits, which the TINY cell is held to as well."""
    return json.loads((REPO / "portbench" / "limits" / "vol3d_s1024_v4x32.json").read_text())


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_benchmark(tmp_path)
    add_tiny_cell(root, real_limits())
    return root


@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason; decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
