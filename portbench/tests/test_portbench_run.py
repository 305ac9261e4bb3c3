"""A TINY cell added by files alone runs end to end on the CPU and prints
the contract's keys; its throwaway metric is read by its own file."""

import json

import pytest

from conftest import TINY_CELL
from portbench.lib import bench


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_the_contract_keys(tiny_root, trace, capsys):
    args = bench.parse(["--workload", TINY_CELL, "--seed", "3000000007", "--seconds", "1",
                        "--trace", str(trace), "--root", str(tiny_root)])
    res = bench.run(args, 0.0, device="cpu")
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    if trace:
        # the throwaway reader; the device readers find no card and stay silent
        assert res["metrics"] == {"tinyprobe.units": {"value": float(res["attempted"]),
                                                      "unit": "units"}}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert set(res["metrics"]) == {"slices_per_s", "setup_s"}
        assert res["metrics"]["slices_per_s"]["value"] > 0
    json.dumps(res)
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("check logit_rel_l2: ")


def test_same_seed_same_inputs_and_weights():
    import torch

    from portbench.loops.propagate_volumes import make_volume
    from portbench.lib.weights import make_weights

    leaves = [("a.weight", (4, 3), False), ("a.bias", (4,), False), ("n.weight", (4,), False),
              ("buf", (2, 8), True)]
    w1 = make_weights(leaves, 2 ** 31 + 12345, "cpu")
    w2 = make_weights(list(reversed(leaves)), 2 ** 31 + 12345, "cpu")
    for k in w1:
        assert torch.equal(w1[k], w2[k])
    assert not torch.equal(w1["a.weight"], make_weights(leaves, 7, "cpu")["a.weight"])
    assert (w1["n.weight"] - 1).abs().max() < 0.2
    f1, b1 = make_volume(2 ** 33 + 5, 1, 6, 64, 3, "cpu")
    f2, b2 = make_volume(2 ** 33 + 5, 1, 6, 64, 3, "cpu")
    assert torch.equal(f1, f2) and torch.equal(b1, b2)
    assert f1.shape == (6, 64, 64, 3)
    assert (b1[1] > b1[0]).all()
