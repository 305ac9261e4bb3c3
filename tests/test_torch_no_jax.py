"""The PyTorch port imports neither JAX nor the JAX package, and never uses a
library attention kernel or ``torch.compile``."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import medsam2_tpu_torch

torch.set_num_threads(2)

PKG = Path(medsam2_tpu_torch.__file__).parent
ROOT = PKG.parent
# the port's own entry points beside the package
SCRIPTS = [ROOT / "chip_smoke.py", *sorted((ROOT / "scripts").glob("profile_port_*.py"))]
JAX_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|medsam2_tpu)\b", re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "medsam2_tpu_torch."))


def test_importing_every_module_leaves_jax_unloaded():
    mods = _modules()
    assert "medsam2_tpu_torch.api.video_predictor" in mods
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'medsam2_tpu'))\n"
            + "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"JAX or JAX-package modules loaded: {res.stdout.strip()}"


def test_sources_have_no_jax_import_library_attention_or_compile():
    """The package never calls a library attention kernel or
    ``torch.compile``; ``chip_smoke.py`` may time ``F.scaled_dot_product_attention``
    as the library yardstick beside each kernel (its ``library_ms``), and
    nothing else."""
    banned = ("scaled_dot_product_attention", "torch.compile")
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert files
    for path in files + SCRIPTS:
        text = path.read_text()
        match = JAX_IMPORT.search(text)
        assert match is None, f"{path.relative_to(ROOT)} imports {match.group(2)}"
        allowed = banned[:1] if path.name == "chip_smoke.py" else ()
        for word in banned:
            if word not in allowed:
                assert word not in text, f"{path.relative_to(ROOT)} contains {word!r}"


# the modules of the 3D session (corrections and clearing included) and of
# the 3D recipe (training over the roped-key cache included), and the other
# modules they run
SESSION_MODULES = ["medsam2_tpu_torch.api.video_predictor", "medsam2_tpu_torch.core.sam2_model",
                   "medsam2_tpu_torch.core.memory", "medsam2_tpu_torch.core.transformer",
                   "medsam2_tpu_torch.state.memory_bank",
                   "medsam2_tpu_torch.ops.connected_components",
                   "medsam2_tpu_torch.train.recipe_3d", "medsam2_tpu_torch.cli.train_3d"]


@pytest.mark.parametrize("module", SESSION_MODULES)
def test_session_modules_load_neither_jax_nor_pil(module):
    """Each module of the 3D session imports on its own without JAX, the
    JAX package or PIL: frames are decoded with PIL only inside
    ``video_predictor._decode_frame``, so a host without PIL runs every
    session that does not read a frame directory."""
    _loads_nothing(module)


def _loads_nothing(module):
    """Import ``module`` alone in a fresh interpreter; fail if JAX, the JAX
    package or PIL came with it."""
    assert module in _modules()
    code = (f"import sys\nimport {module}\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'medsam2_tpu', 'PIL'))\nprint(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"{module} loads {res.stdout.strip()}"


# the modules of the REFUGE 2D training slice
TWO_D_MODULES = ["medsam2_tpu_torch.state.similarity_bank", "medsam2_tpu_torch.train.recipe_2d",
                 "medsam2_tpu_torch.data.refuge", "medsam2_tpu_torch.data.synthetic",
                 "medsam2_tpu_torch.cli.train_2d", "medsam2_tpu_torch.ops.fused_mlp",
                 "medsam2_tpu_torch.ops.fused_block"]


@pytest.mark.parametrize("module", TWO_D_MODULES)
def test_2d_modules_load_neither_jax_nor_pil(module):
    """Each module of the 2D slice imports on its own without JAX, the JAX
    package or PIL: the REFUGE reader imports PIL only when it reads a
    sample, so the synthetic data and the chip run need no PIL."""
    _loads_nothing(module)


# the modules of the nuclei serving slice
NUCLEI_MODULES = ["medsam2_tpu_torch.prompter.backbone", "medsam2_tpu_torch.prompter.fpn",
                  "medsam2_tpu_torch.prompter.dpa_p2pnet",
                  "medsam2_tpu_torch.api.nuclei_inference", "medsam2_tpu_torch.data.monuseg",
                  "medsam2_tpu_torch.metrics.instance", "medsam2_tpu_torch.metrics.detection",
                  "medsam2_tpu_torch.checkpoint.convert"]


@pytest.mark.parametrize("module", NUCLEI_MODULES)
def test_nuclei_modules_load_neither_jax_nor_pil(module):
    """Each module of the nuclei serving slice imports on its own without
    JAX, the JAX package or PIL: the MoNuSeg reader imports PIL and scipy's
    ``.mat`` reader only when it reads a sample."""
    _loads_nothing(module)


# the modules of the nuclei training slice
NUCLEI_TRAIN_MODULES = ["medsam2_tpu_torch.data.augment", "medsam2_tpu_torch.prompter.matcher",
                        "medsam2_tpu_torch.prompter.criterion",
                        "medsam2_tpu_torch.train.recipe_nuclei"]


@pytest.mark.parametrize("module", NUCLEI_TRAIN_MODULES)
def test_nuclei_train_modules_load_neither_jax_nor_pil(module):
    """Each module of the nuclei training slice imports on its own without
    JAX, the JAX package or PIL (the matcher imports scipy's assignment
    solver when it runs)."""
    _loads_nothing(module)
