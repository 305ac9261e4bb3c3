"""The import guard: no JAX and no JAX package in a run, nothing of the
program in the reference."""

import subprocess
import sys
import types

from conftest import REPO
from portbench.lib import bench


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "medsam2_tpu_torch_fake", types.ModuleType("x"))
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "medsam2_tpu.core", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert bench.forbidden_modules() == ["jax", "medsam2_tpu"]


def test_guard_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    try:
        bench.guard_imports("after the window")
    except bench.RunError as e:
        assert "flax" in str(e)
    else:
        raise AssertionError("the guard let flax through")


def test_reference_sources_import_nothing_of_the_program(tmp_path):
    assert bench.reference_imports(REPO) == []
    ref = tmp_path / "portbench" / "reference"
    ref.mkdir(parents=True)
    (ref / "bad.py").write_text("from medsam2_tpu_torch.core import layers\nimport jax\n")
    assert bench.reference_imports(tmp_path) == ["bad.py: jax",
                                                 "bad.py: medsam2_tpu_torch.core"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.sam2_plain, portbench.counts.propagation; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'medsam2_tpu', 'medsam2_tpu_torch'}); print(bad)"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
                          "vol3d_s1024_v4x32", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
