"""The plain reference against the port's plain path at TINY on the CPU, and
the control (the reference in fp8) against the limit."""

import pytest
import torch

from conftest import TINY_CELL, TINY_SIZE, add_tiny_cell, copy_benchmark, real_limits

from portbench.calibrate import readings


def test_reference_matches_the_ports_plain_path(tiny_root):
    r = next(readings(TINY_CELL, [3000000011], None, root=tiny_root, device="cpu"))
    # fp32 on both sides: the port's plain twins and the reference differ
    # only in the order of float32 sums
    assert r["program"]["logit_rel_l2"] < 1e-4


@pytest.mark.parametrize("seed", [3000000012, 3000000013])
def test_control_separates_from_the_bf16_program(tmp_path, seed):
    """At TINY the program in bf16 (the configuration's precision) and the
    control (the reference in fp8) read at least three times apart, as the
    full-size readings that set the limit do; the full-size control against
    the limit itself is ``test_portbench_chip.py``'s, on the card."""
    root = copy_benchmark(tmp_path)
    add_tiny_cell(root, real_limits(), compute_dtype="bfloat16")
    r = next(readings(TINY_CELL, [seed], "fp8", root=root, device="cpu"))
    assert r["control"]["logit_rel_l2"] > 3 * r["program"]["logit_rel_l2"]
    assert r["program"]["logit_rel_l2"] < real_limits()["logit_rel_l2"]


def test_reference_is_deterministic():
    """Two propagations of one volume give the same logits, bit for bit."""
    from conftest import tiny_model
    from portbench.loops.propagate_volumes import make_volume
    from portbench.lib.bench import build_port_model
    from portbench.lib.weights import make_weights
    from portbench.reference.sam2_plain import PlainSAM2

    model = tiny_model()
    port, _ = build_port_model({"preset": "sam2_hiera_s", "name": "t", "model": model,
                                "overrides": {"image_size": TINY_SIZE,
                                              "compute_dtype": "float32"}}, "cpu")
    leaves = [(n, tuple(t.shape), n in dict(port.named_buffers()))
              for n, t in port.state_dict().items()]
    ref = PlainSAM2(make_weights(leaves, 99, "cpu"), model)
    f, b = make_volume(99, 0, 4, TINY_SIZE, 3, "cpu")
    lab = torch.tensor([2, 3])
    out1 = ref.propagate(f, b, lab)["low"]
    out2 = ref.propagate(f.clone(), b.clone(), lab)["low"]
    assert torch.equal(out1, out2)
    assert out1.shape == (4, 1, TINY_SIZE // 4, TINY_SIZE // 4)


@pytest.mark.parametrize("scores,want", [((0.50, 0.49, 0.10), 1), ((0.50, 0.40, 0.10), 0)])
def test_choice_follows_the_judged_mask_only_at_a_tie(scores, want):
    """The judged mask is nearest candidate 1: the reference takes it where
    its score lies within the tie of the best (0.01 < 0.02), and keeps its
    own best otherwise (0.10 > 0.02), the error then against its best."""
    from portbench.reference.sam2_plain import PlainSAM2

    cands = torch.stack([torch.full((4, 4), v) for v in (1.0, 2.0, 3.0)])[None]
    heads = {"cands": cands, "scores": torch.tensor([scores])}
    out = {"err": [], "gap": []}
    k = PlainSAM2._choose(None, heads, cands[0, 1] + 0.01, 0.02, out)
    assert int(k) == want
    assert float(out["gap"][0]) == pytest.approx(scores[0] - scores[1])
    assert float(out["err"][0]) == pytest.approx(0.01 / 2.0 if want == 1 else 1.01 / 1.0)
