"""Plant known faults in copies of the port's attention kernels and show that
``chip_smoke.py`` phase 3 and the ``cuda`` kernel tests catch each, on one GPU.

    python3 scripts/profile_port_planted_faults.py [FAULT ...] [--dir DIR]

For each fault (default: all) the package, the tests and ``chip_smoke.py``
are copied to ``<DIR>/planted_<fault>`` (default DIR: ``build/planted`` of
this checkout, which git ignores), one line of one CUDA source is
changed there, and the copy runs phase 3 (build, then the propagation
kernels against their twins) and the attention cases of
``tests/test_torch_kernels_cuda.py``. Each must fail; the script prints the
phase-3 lines, the failing tests, and exits non-zero if a fault went
unnoticed. The checkout itself is never changed.
"""

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# name: (source, text, replacement)
FAULTS = {
    # B1/B2: O is not rescaled by alpha when the running max grows
    "alpha": ("medsam2_tpu_torch/csrc/hopper_attention.cuh",
              "      o[4 * j] *= al_a;\n      o[4 * j + 1] *= al_a;\n"
              "      o[4 * j + 2] *= al_b;\n      o[4 * j + 3] *= al_b;\n", ""),
    # the merge drops the last split's partial output
    "merge_last": ("medsam2_tpu_torch/csrc/flash_attention.cu",
                   "    for (int s = 0; s < splits; ++s) {\n      const size_t prow",
                   "    for (int s = 0; s < splits - 1; ++s) {\n      const size_t prow"),
    # B2 keys without their positional rows
    "no_pos": ("medsam2_tpu_torch/csrc/kv_cached_attention.cu",
               "za[e] = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);",
               "za[e] = __floats2bfloat162_rn(fx.x + 0.f * fy.x, fx.y + 0.f * fy.y);"),
}


def run(name: str, base: Path) -> bool:
    path, old, new = FAULTS[name]
    d = base / f"planted_{name}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for part in ("medsam2_tpu_torch", "tests", "chip_smoke.py", "pytest.ini"):
        src = ROOT / part
        if src.is_dir():
            shutil.copytree(src, d / part, ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy(src, d / part)
    f = d / path
    text = f.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: the line to change is not in {path} exactly once")
    f.write_text(text.replace(old, new))
    print(f"==== fault {name}: {path}", flush=True)
    smoke = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as s; s.phase_build(); s.phase_kernels()"],
        cwd=d, capture_output=True, text=True, timeout=600)
    for line in smoke.stdout.splitlines():
        if line.startswith("[3 kernel]"):
            print("   ", line, flush=True)
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda", "-p",
         "no:cacheprovider", "tests/test_torch_kernels_cuda.py", "-k",
         "flash or kv_cached or merge", "-rf"],
        cwd=d, capture_output=True, text=True, timeout=600)
    out = tests.stdout.strip().splitlines()
    print(f"   phase 3 exit {smoke.returncode}; tests: {out[-1] if out else tests.stderr[-300:]}")
    for line in out:
        if line.startswith("FAILED"):
            print("     ", line, flush=True)
    return smoke.returncode != 0 and tests.returncode != 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("faults", nargs="*", help=f"any of {list(FAULTS)} (default: all)")
    ap.add_argument("--dir", default=str(ROOT / "build" / "planted"))
    args = ap.parse_args()
    unknown = set(args.faults) - set(FAULTS)
    if unknown:
        ap.error(f"unknown faults {sorted(unknown)}")
    missed = [n for n in (args.faults or FAULTS) if not run(n, Path(args.dir))]
    print(f"unnoticed faults: {missed}" if missed else "every planted fault was caught")
    sys.exit(1 if missed else 0)


if __name__ == "__main__":
    main()
