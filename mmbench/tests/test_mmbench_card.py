"""The control at each cell's own size, on the card: the program within
every limit, the reference in TF32 in its place outside one at least.

    python -m pytest mmbench/tests/test_mmbench_card.py -q -m cuda

Each case sets up its cell's scene and runs one unit of its traffic (a
minute or two a case); without a card they skip."""

from __future__ import annotations

import pytest

from mmbench import calibrate, harness

ROOT = harness.MMBENCH.parent
CELLS = [w["name"] for w in harness.Registry(ROOT).spec["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [901, 2**31 + 902, 903])
def test_the_control_fails_where_the_program_passes(card, workload, seed):
    reg = harness.Registry(ROOT)
    numbers = calibrate.readings(reg, workload, seed, True, card)
    work = reg.workload(workload)
    limits = {**reg.config(work["config"])["guarantees"], **reg.limits(workload)["checks"]}
    assert all(numbers[k] <= v for k, v in limits.items()), numbers
    assert any(numbers[f"tf32:{k}"] > v for k, v in limits.items() if f"tf32:{k}" in numbers)
