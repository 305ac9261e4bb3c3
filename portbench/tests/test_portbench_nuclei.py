"""The joint nuclei training cell on the CPU at TINY widths: the plain
reference follows the program's steps (the bank empty, then full) to fp32
round-off, draws the program's dropout masks, takes the program's match only
within ``match_tie``, and reads ``correct`` false under each planted fault.
The registry finds every file of the cell by name."""

import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import REPO, copy_benchmark
from nuclei_tiny import FAULTS, TINY_NUCLEI, add_tiny_nuclei, undo
from portbench.lib import bench

CELL = "nuclei_train_n256_b16"
SEED = 3000000011
# fp32 against fp32 in another order of operations: the losses, the module
# gradients, the batch statistics, the decoder's logits and the memories agree
# to ~1e-6 relative (read 6e-7 to 1e-5); AdamW's update divides by sqrt(v) + eps and turns the
# round-off of small gradient elements into visible steps (read 3e-5), and
# one leaf's gradient norm can sit on a cancellation (read 1.3e-4)
TOL = {"loss_rel": 1e-4, "grad_group_gap": 1e-4, "update_gap": 1e-3, "bn_rel": 1e-5,
       "bank_rel": 1e-5, "cell_logit_rel": 1e-5}
TOL_GRAD_LEAF = 1e-3


def tiny_loop(root, fault=None):
    """The TINY cell's loop after its checked steps, with ``fault`` planted
    before them; the program released."""
    b = bench.load_benchmark(root)
    cell = bench.find_cell(b, TINY_NUCLEI)
    traffic = bench.load_json("traffic", cell["traffic"], root)
    loop = bench.load_loop(traffic)(bench.load_config(b, cell["config"], root), traffic, SEED,
                                    torch.device("cpu"))
    loop.setup(bench.build_port_model)
    try:
        if fault is not None:
            FAULTS[fault](loop)
        loop.warm()
    finally:
        undo(loop)
    loop.release()
    return loop, bench.load_json("limits", TINY_NUCLEI, root)


def _tiny_root(tmp, steps: int):
    """A checkout with the TINY cell checking ``steps`` steps."""
    root = copy_benchmark(tmp)
    add_tiny_nuclei(root)
    tr = json.loads((root / "portbench" / "traffic" / "tiny_nuclei.json").read_text())
    tr["checked_steps"] = steps
    (root / "portbench" / "traffic" / "tiny_nuclei.json").write_text(json.dumps(tr))
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """The TINY cell checking two steps: the bank empty, then full."""
    return _tiny_root(tmp_path_factory.mktemp("nuclei"), 2)




@pytest.fixture(scope="module")
def followed(tiny_root):
    """(the loop, the compared numbers, the diagnostics) of a sound run."""
    from portbench.loops.train_nuclei import compare

    loop, limits = tiny_loop(tiny_root)
    ties = {k: limits[k] for k in ("point_tie", "match_tie")}
    got = [dict(rec, update=loop.program_update(t)) for t, rec in enumerate(loop.records)]
    numbers, diag = compare(got, loop.follow("fp32", got, ties))
    return loop, numbers, diag


def test_reference_follows_the_program_over_two_steps(followed):
    loop, numbers, diag = followed
    assert loop.records[0]["bank"] is None and "bank_idx" not in loop.records[0]
    assert loop.records[1]["bank"] is not None and loop.records[1]["bank_idx"].shape[0] == 2
    for k, tol in TOL.items():
        assert numbers[k] < tol, (k, numbers[k])
    assert diag["grad_leaf_gap"] < TOL_GRAD_LEAF, diag["worst"]


def test_reference_redraws_the_programs_dropout_masks():
    from medsam2_tpu_torch.core.memory import dropout as memory_dropout
    from medsam2_tpu_torch.prompter.dpa_p2pnet import head_dropout

    from portbench.reference.nuclei_plain import dropout

    x = torch.randn(2, 16, 32)
    for program in (head_dropout, memory_dropout):
        g_prog, g_ref = (torch.Generator().manual_seed(2 ** 40 + 3) for _ in range(2))
        for shape in ((2, 16, 32), (2, 16, 64), (2, 16, 32)):
            x = torch.randn(shape)
            assert torch.equal(program(x, 0.1, g_prog), dropout(x, 0.1, g_ref))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_incorrect(tiny_root, fault):
    loop, limits = tiny_loop(tiny_root, fault)
    checks = loop.check(limits)
    assert any(c["value"] > c["limit"] for c in checks), checks


@pytest.mark.parametrize("control", ["lower", "sam_fp8"])
def test_control_reads_incorrect(followed, tiny_root, control):
    """The plain reference one step below the stated precision in the
    program's place, both parts or SAM 2 alone, fails a limit."""
    loop = followed[0]
    checks = loop.check(bench.load_json("limits", TINY_NUCLEI, tiny_root), control=control)
    assert any(c["value"] > c["limit"] for c in checks), checks


def _trainer():
    doc = json.loads((REPO / "portbench" / "configs" / "nuclei_256_resnet50.json").read_text())
    return SimpleNamespace(rcfg=doc["recipe"])


def test_match_tie_takes_the_programs_assignment_only_within_the_tie():
    """Two predictions nearly equidistant from two cells: the program's
    swapped assignment costs ``gap`` more under the reference's cost."""
    from portbench.reference.nuclei_plain import PlainNucleiTrainer, match_cost

    eps = 0.004
    outputs = {"pred_coords": torch.tensor([[[15.0 - eps, 10.0], [15.0 + eps, 10.0],
                                             [90.0, 90.0]]]),
               "pred_logits": torch.zeros(1, 3, 2)}
    batch = {"gt_points": torch.tensor([[[10.0, 10.0], [20.0, 10.0]]]),
             "gt_labels": torch.zeros(1, 2, dtype=torch.long),
             "gt_valid": torch.ones(1, 2, dtype=torch.bool)}
    cost = match_cost(_trainer().rcfg, outputs["pred_coords"].numpy(),
                      outputs["pred_logits"].numpy(), batch["gt_points"].numpy(),
                      batch["gt_labels"].numpy(), batch["gt_valid"].numpy())
    own, swapped = np.array([[0, 1]]), np.array([[1, 0]])
    gap = cost[0, [1, 0], [0, 1]].sum() - cost[0, [0, 1], [0, 1]].sum()
    assert 0 < gap < 1e-2
    choose = PlainNucleiTrainer.choose_match
    _, taken, gaps = choose(_trainer(), outputs, batch, swapped, tie=2 * gap)
    assert np.array_equal(taken, swapped) and gaps["taken"] == pytest.approx(gap)
    _, kept, gaps = choose(_trainer(), outputs, batch, swapped, tie=gap / 2)
    assert np.array_equal(kept, own) and gaps["n"] == 1 and gaps["taken"] == 0.0


def test_point_tie_takes_the_programs_point_only_within_the_tie():
    from portbench.reference.nuclei_plain import PlainNucleiTrainer

    pred = torch.tensor([[[10.0, 10.0], [10.0, 10.02], [40.0, 40.0]]])
    batch = {"gt_points": torch.tensor([[[10.0, 9.99]]]),
             "gt_valid": torch.ones(1, 1, dtype=torch.bool)}
    prog = torch.tensor([[1]])
    _, idx, gaps = PlainNucleiTrainer.choose_points(None, pred, batch, prog, tie=0.1)
    assert idx.tolist() == [[1]] and 0 < gaps["taken"] < 0.1
    _, idx, gaps = PlainNucleiTrainer.choose_points(None, pred, batch, prog, tie=0.01)
    assert idx.tolist() == [[0]] and gaps["n"] == 1


def test_tiles_are_synthetic_nuclei_tinted():
    from medsam2_tpu_torch.data.synthetic import synthetic_nuclei

    from portbench.loops.train_nuclei import EOSIN, HEMATOXYLIN, make_tile

    for seed, n in ((5, 40), (2 ** 35 + 1, 64)):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        rgb, inst = make_tile(r1, 128, n)
        s = synthetic_nuclei(r2, 128, n)
        assert np.array_equal(inst, s["inst_map"])
        tinted = HEMATOXYLIN + (s["image"] - 0.35) / 0.5 * (EOSIN - HEMATOXYLIN)
        np.testing.assert_allclose(rgb, np.clip(tinted * 255.0, 0, 255), rtol=0, atol=1e-3)
        assert r1.integers(2 ** 62) == r2.integers(2 ** 62)


def test_resnet50_count_is_the_published_one():
    """ResNet-50 at 224 px: 4.09 GMACs without its classifier (8.2 GFLOP)."""
    from portbench.counts.nuclei_train import resnet_flops

    f, levels = resnet_flops("resnet50", 224)
    assert 8.0e9 < f < 8.3e9
    assert levels == [(56, 256), (28, 512), (14, 1024), (7, 2048)]


def test_registry_finds_the_cell_by_name():
    b = bench.load_benchmark(REPO)
    cell = bench.find_cell(b, CELL)
    assert cell["chips"] == 1 and cell["config"] == "nuclei_256_resnet50"
    cfg = bench.load_config(b, cell["config"], REPO)
    assert cfg["reduced"] == [] and cfg["prompter"]["backbone"] == "resnet50"
    traffic = bench.load_json("traffic", cell["traffic"], REPO)
    assert bench.load_loop(traffic).__module__ == "portbench.loops.train_nuclei"
    assert traffic["rate_metric"] == "train_images_per_s"
    assert set(bench.load_json("limits", CELL, REPO)) >= {
        "loss_rel", "grad_group_gap", "update_gap", "bn_rel", "bank_rel", "cell_logit_rel"}
    layer = {m["name"] for m in bench.cell_metrics(b, CELL, "per_layer")}
    assert layer == {f"{m}.nuclei_train" for m in (
        "mfu", "device_idle", "device_ms_per_image", "launches_per_image", "prompter_roofline",
        "encoder_roofline")}
    for m in layer:
        assert callable(bench.load_reader(m, REPO))
    e2e = {m["name"] for m in bench.cell_metrics(b, CELL, "end_to_end")}
    assert e2e == {"train_images_per_s", "setup_s"}


def test_nuclei_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.nuclei_plain, portbench.counts.nuclei_train; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'medsam2_tpu', 'medsam2_tpu_torch'}); print(bad)"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
