"""The port's ``train_2d`` CLI (the REFUGE workload) on the CPU at TINY,
mirroring ``tests/test_cli.py::test_train_2d_cli_synthetic``: synthetic
fundus data at ``-image_size 64``, two steps, validation capped by
``-val_max_samples``; the REFUGE reader on a directory the test writes; the
flags of the reference commands; and the options that raise with a
pointer to ROADMAP (the nuclei workload: ``tests/test_torch_nuclei_train.py``)."""

import glob
import json

import pytest
import torch

import medsam2_tpu_torch.cli.train_2d as t2
from medsam2_tpu_torch.cli.cfg import parse_args
from tests.test_predictors import TINY
from tests.test_torch_refuge_data import _write_refuge

torch.set_num_threads(2)
BASE = ["-net", "sam2", "-image_size", "64", "-out_size", "64", "-epochs", "1",
        "-steps_per_epoch", "2", "-val_freq", "1", "-b", "2", "-print_freq", "1",
        "-device", "cpu", "-val_max_samples", "2"]


def _run(monkeypatch, argv):
    monkeypatch.setattr(t2, "get_config", lambda name, **kw: TINY)
    calls = {"step": 0, "val": 0}
    step, val = t2.recipe_2d.make_train_step_2d, t2.validate_refuge

    def counted_step(*a, **k):
        inner = step(*a, **k)

        def run(*b, **kw):
            calls["step"] += 1
            return inner(*b, **kw)

        return run

    def counted_val(args, model, rcfg, val_ds, bank):
        calls["val"] += min(len(val_ds), args.val_max_samples)
        return val(args, model, rcfg, val_ds, bank)

    monkeypatch.setattr(t2.recipe_2d, "make_train_step_2d", counted_step)
    monkeypatch.setattr(t2, "validate_refuge", counted_val)
    return t2.main(argv), calls


def test_train_2d_cli_synthetic(tmp_path, monkeypatch):
    model, calls = _run(monkeypatch, BASE + ["-dataset", "synthetic", "-logdir", str(tmp_path)])
    assert model is not None and model.device.type == "cpu"
    assert calls == {"step": 2, "val": 2}
    jl = glob.glob(str(tmp_path / "*" / "Log" / "scalars.jsonl"))
    rows = [json.loads(ln) for ln in open(jl[0])]
    assert any("train/loss" in str(r) for r in rows) and any("val/dice" in str(r) for r in rows)
    assert all(p.requires_grad for p in model.parameters())


def test_train_2d_cli_reads_refuge(tmp_path, monkeypatch):
    """``-dataset refuge -data_path``: the Training-400 folders train, the
    Test-400 ones validate."""
    root = tmp_path / "REFUGE"
    _write_refuge(str(root))
    (root / "Training-400").rename(root / "Test-400")
    _write_refuge(str(root))
    model, calls = _run(monkeypatch, BASE + ["-dataset", "refuge", "-data_path", str(root),
                                             "-logdir", str(tmp_path / "logs")])
    assert calls == {"step": 1, "val": 2}     # two training cases: one batch of 2


def test_train_2d_reference_flags_and_unported_workloads(tmp_path, monkeypatch):
    args = parse_args("-net sam2 -exp_name REFUGE -dataset refuge -data_path ./data/REFUGE "
                      "-image_size 1024 -out_size 1024 --clip-grad 0.05 -memory_bank_size 8 "
                      "-val_max_samples 3".split())
    assert (args.device, args.clip_grad, args.memory_bank_size) == ("cuda", 0.05, 8)
    assert (args.out_size, args.val_max_samples) == (1024, 3)
    nuclei = parse_args("-net prompter -dataset monuseg -max_cells 32 -augment 0 "
                        "--overlap 32 --crop_size 128".split())
    assert (nuclei.max_cells, nuclei.augment, nuclei.overlap, nuclei.crop_size) == (32, 0, 32,
                                                                                    128)
    sample = t2.SyntheticDataset(parse_args(["-image_size", "64"]), "nuclei")[0]
    assert sample["inst_masks"].shape[1:] == (64, 64)
    monkeypatch.setattr(t2, "get_config", lambda name, **kw: TINY)
    for argv in (["-distributed", "data"], ["-vis", "1"]):
        with pytest.raises(NotImplementedError, match="A.7"):
            t2.main(argv + ["-dataset", "synthetic", "-device", "cpu"])
    if not torch.cuda.is_available():
        # the default device is the card: no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t2.main(["-dataset", "synthetic", "-image_size", "64", "-logdir", str(tmp_path)])
