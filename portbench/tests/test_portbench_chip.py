"""On the card: the cell's program and its control at full size, through the
same readings that set the limit (``portbench/calibrate.py``). Skips where
there is no card; run on the chip with

    python -m pytest portbench/tests/test_portbench_chip.py -m cuda -q
"""

import pytest

from conftest import REPO, real_limits

pytestmark = pytest.mark.cuda


def test_program_within_and_control_beyond_the_limit(cuda_device):
    from portbench.calibrate import readings

    limit = real_limits()["logit_rel_l2"]
    r = next(readings("vol3d_s1024_v4x32", [8000000001], "fp8", root=REPO,
                      device=cuda_device))
    assert r["program"]["logit_rel_l2"] <= limit
    assert r["control"]["logit_rel_l2"] > limit
