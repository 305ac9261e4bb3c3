"""Plant known faults in copies of the port's attention kernels and show that
``chip_smoke.py`` and the ``cuda`` kernel tests catch each, on one GPU.

    python3 scripts/profile_port_planted_faults.py [FAULT ...] [--dir DIR] [--e2e]

For each fault (default: all) the package, the tests and ``chip_smoke.py``
are copied to ``<DIR>/planted_<fault>`` (default DIR: ``build/planted`` of
this checkout, which git ignores), one passage of one CUDA source is
changed there, and the copy builds the kernels, runs the fault's phase
(3 for the propagation kernels, 3b for the backward, 8 for the encoder
kernels and the encoder linear; not phase 2's SASS check, so that a fault
is caught on values) and
the fault's cases of ``tests/test_torch_kernels_cuda.py``. Each must
fail; the script prints the phase's lines, the failing tests, and exits
non-zero if a fault went unnoticed. With ``--e2e`` an encoder fault runs
through phase 11 instead of its kernel phase (hiera_b+ and hiera_l
``set_image`` @1024 bf16, switches on against off, held to
``TOL_BL_EMBED``), which shows how far that end-to-end reading moves. The
checkout itself is never changed.
"""

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (call of chip_smoke.py's phase, its line prefix, the tests' -k filter)
PROPAGATION = ("phase_kernels()", "[3 kernel]", "flash or kv_cached or merge")
BACKWARD = ("phase_train_kernels()", "[3b train kernel]", "dq or lse_and_backward")
DKV = ("phase_train_kernels()", "[3b train kernel]", "dkv or lse_and_backward")
WINDOW = ("phase_encoder_kernels()", "[8 encoder kernel] window", "window")
MLP = ("phase_encoder_kernels()", "[8 encoder kernel]", "fused_mlp or fused_block")
LINEAR = ("phase_encoder_kernels()", "[8 encoder", "linear or fused_mlp or fused_block")
E2E = ("phase_bl_set_image('')", "[11 b+/l set_image]")
# name: (source, text, replacement, check)
FAULTS = {
    # B1/B2: O is not rescaled by alpha when the running max grows
    "alpha": ("medsam2_tpu_torch/csrc/hopper_attention.cuh",
              "      o[4 * j] *= al_a;\n      o[4 * j + 1] *= al_a;\n"
              "      o[4 * j + 2] *= al_b;\n      o[4 * j + 3] *= al_b;\n", "", PROPAGATION),
    # the merge drops the last split's partial output
    "merge_last": ("medsam2_tpu_torch/csrc/flash_attention.cu",
                   "    for (int s = 0; s < splits; ++s) {\n      const size_t prow",
                   "    for (int s = 0; s < splits - 1; ++s) {\n      const size_t prow",
                   PROPAGATION),
    # B2 keys without their positional rows
    "no_pos": ("medsam2_tpu_torch/csrc/kv_cached_attention.cu",
               "za[e] = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);",
               "za[e] = __floats2bfloat162_rn(fx.x + 0.f * fy.x, fx.y + 0.f * fy.y);",
               PROPAGATION),
    # B4: the split sum drops the last split's partial dQ
    "dq_sum_last": ("medsam2_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
                    "for (int s = 1; s < splits; ++s) {",
                    "for (int s = 1; s < splits - 1; ++s) {", BACKWARD),
    # B4: dS of masked keys is not zeroed (P not multiplied by the mask)
    "dq_no_mask": ("medsam2_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
                   "const float2 m2 = *reinterpret_cast<const float2*>(mk + 8 * j + 2 * quad);",
                   "const float2 m2 = make_float2(1.f, 1.f);", BACKWARD),
    # B5: logits of the first 8 padded key columns (n to n + 8) are not
    # masked; the same comparisons, so the same registers
    "win_pad_unmasked": ("medsam2_tpu_torch/csrc/window_attention_sm90.cu",
                         "      if (col >= G::kN) sc[g][4 * j] = sc[g][4 * j + 2] = kNegInf;\n"
                         "      if (col + 1 >= G::kN) sc",
                         "      if (col >= G::kN + 8) sc[g][4 * j] = sc[g][4 * j + 2] = kNegInf;\n"
                         "      if (col + 1 >= G::kN + 8) sc", WINDOW),
    # B5: the second query part loads its query rows one window row too high
    "win_part_offset": ("medsam2_tpu_torch/csrc/window_attention_sm90.cu",
                        "y0 + part * G::kHY);", "y0 + part * (G::kHY - 1));", WINDOW),
    # B5 at d 56: the map's innermost dim spans 64 channels, so channels 56-63
    # of q, k and v are the next head's instead of TMA's zero fill
    "win_d56_unzeroed": ("medsam2_tpu_torch/csrc/window_attention_sm90.cu",
                         "const uint64_t dims[4] = {D, 3 * (uint64_t)a.heads,",
                         "const uint64_t dims[4] = {D == 56 ? 64 : D, 3 * (uint64_t)a.heads,",
                         WINDOW),
    # B3: P^T and dS^T of masked keys are not zeroed (the mask read as 1)
    "dkv_no_mask": ("medsam2_tpu_torch/csrc/flash_bwd_dkv_sm90.cu",
                    "  const float m_a = sh.mask()[r_a];\n  const float m_b = sh.mask()[r_a + 8];",
                    "  const float m_a = 1.f;\n  const float m_b = 1.f;", DKV),
    # B3: a split's run of q tiles rounds down, so the last split drops the
    # tiles past splits * floor(tiles / splits)
    "dkv_split_drop": ("medsam2_tpu_torch/csrc/flash_bwd_dkv_sm90.cu",
                       "const int per_split = (n_qt + a.splits - 1) / a.splits;",
                       "const int per_split = n_qt / a.splits;", DKV),
    # B3 at the Hiera head dims: the 32-wide chunk's dK / dV products (columns
    # 64-95 at D 96) are not issued
    "dkv_narrow_chunk": ("medsam2_tpu_torch/csrc/flash_bwd_dkv_sm90.cu",
                         "    else if constexpr (W == 32)\n      wgmma_ss_n32_tb(acc, da, db);",
                         "    else if constexpr (W == 32)\n      ;", DKV),
    # B4 at D 72: the epilogue writes dQ's first 64 columns only (64-71 of
    # the fresh output stay as allocated)
    "dq_d72_cols": ("medsam2_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
                    "    for (int j = 0; j < D / 8; ++j)\n      *reinterpret_cast<float2*>(dst",
                    "    for (int j = 0; j < (D == 72 ? 8 : D / 8); ++j)\n"
                    "      *reinterpret_cast<float2*>(dst", BACKWARD),
    # B7 at C <= 256: the last hidden chunk's fc2 product reads the previous
    # chunk's fc2 weight columns
    "mlp_fused_last_chunk": ("medsam2_tpu_torch/csrc/encoder_gemm.cu",
                             "tma_load_3d(st + L::kW1Bytes, &maps.w2, full + s, j * kHC, 0, 0);",
                             "tma_load_3d(st + L::kW1Bytes, &maps.w2, full + s, "
                             "(j == kChunks - 1 ? j - 1 : j) * kHC, 0, 0);", MLP),
    # B7 at C > 224 (and B8's linears): the products of the last 64-wide k
    # chunk of every tile are not issued (the last hidden chunk of fc2); the
    # ring still loads and hands back every chunk
    "mlp_last_chunk": ("medsam2_tpu_torch/csrc/encoder_linear_sm90.cuh",
                       "      for (int i = 0; i < kLK / 16; ++i)\n        WgmmaSS<BN>::mma(",
                       "      for (int i = 0; i < (kt + 1 < k_chunks ? kLK / 16 : 0); ++i)\n"
                       "        WgmmaSS<BN>::mma(", LINEAR),
    # the persistent linear's schedule skips its last round's tiles (all of
    # them where there is one round): producer and consumers alike
    "linear_last_round": ("medsam2_tpu_torch/csrc/encoder_linear_sm90.cuh",
                          "const int tiles = (a.M + kLM - 1) / kLM * n_tiles;",
                          "const int tiles = ((a.M + kLM - 1) / kLM * n_tiles - 1) / "
                          "(int)gridDim.x * (int)gridDim.x;", LINEAR),
    # the residual tile of each consumer warpgroup is loaded from the other
    # warpgroup's 64-row block
    "linear_resid_rows": ("medsam2_tpu_torch/csrc/encoder_linear_sm90.cuh",
                          "n0 + c * kLC, m0 + 64 * h, 0);",
                          "n0 + c * kLC, m0 + 64 * (1 - h), 0);", LINEAR),
    # the TMA store drops the 16-column chunk that straddles N (a ragged
    # column edge: N not a multiple of 16)
    "linear_store_edge": ("medsam2_tpu_torch/csrc/encoder_linear_sm90.cuh",
                          "c < BN / kLC && n0 + c * kLC < a.N; ++c)",
                          "c < BN / kLC && n0 + c * kLC + kLC <= a.N; ++c)", LINEAR),
}


def run(name: str, base: Path, e2e: bool) -> bool:
    path, old, new, (phase, prefix, tests_k) = FAULTS[name]
    if e2e:
        phase, prefix = E2E
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
        raise SystemExit(f"{name}: the passage to change is not in {path} exactly once")
    f.write_text(text.replace(old, new))
    print(f"==== fault {name}: {path}", flush=True)
    smoke = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as s; s._build.build(); "
         f"s._build.load_library(); s.{phase}"],
        cwd=d, capture_output=True, text=True, timeout=900)
    for line in smoke.stdout.splitlines():
        if line.startswith(prefix):
            print("   ", line[:400], flush=True)
    raised = smoke.stderr.strip().splitlines()
    if raised:
        print("    raised:", raised[-1][:300], flush=True)
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda", "-p",
         "no:cacheprovider", "tests/test_torch_kernels_cuda.py", "-k", tests_k, "-rf"],
        cwd=d, capture_output=True, text=True, timeout=900)
    out = tests.stdout.strip().splitlines()
    print(f"   {phase.split('(')[0]} exit {smoke.returncode}; tests: "
          f"{out[-1] if out else tests.stderr[-300:]}")
    for line in out:
        if line.startswith("FAILED"):
            print("     ", line[:200], flush=True)
    return smoke.returncode != 0 and tests.returncode != 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("faults", nargs="*", help=f"any of {list(FAULTS)} (default: all)")
    ap.add_argument("--dir", default=str(ROOT / "build" / "planted"))
    ap.add_argument("--e2e", action="store_true",
                    help="run the faults through phase 11 instead of their kernel phase")
    args = ap.parse_args()
    unknown = set(args.faults) - set(FAULTS)
    if unknown:
        ap.error(f"unknown faults {sorted(unknown)}")
    missed = [n for n in (args.faults or FAULTS) if not run(n, Path(args.dir), args.e2e)]
    print(f"unnoticed faults: {missed}" if missed else "every planted fault was caught")
    sys.exit(1 if missed else 0)


if __name__ == "__main__":
    main()
