"""A run with the timed path broken underneath comes out not correct.

Each fault of :mod:`smcbench.harness.faults` is planted in the program's
own functions before the cell is set up, and the rest of a run (set-up,
window, the check) is driven as ``run.py`` drives it, past its look for a
card. A fault that one number alone catches (``CAUGHT_BY``) reads above
that number's limit.

On the CPU the cells run eagerly at a tiny size, with the statistical
limits widened to that size's Monte Carlo error and the other limits as
the cell states them; the sound program passes there. Marked ``chip``,
the same faults, the sound program and the bfloat16 control run at each
cell's own size and path on the card, under the cell's own limits.
"""

import time

import pytest
import torch

from smcbench.harness.faults import FAULTS, CAUGHT_BY, planted
from smcbench.harness.runner import execute
from smcbench.harness.spec import Cell

CELLS = ("om.100k.graph.sys", "om.1m.graph.res", "sv.100k.graph",
         "om.100k.eager.sys")
#: the CPU stand-ins: tiny, eager, Monte Carlo limits of that size
TINY = {"om.100k.eager.sys": {"particles": 2000},
        "sv.100k.graph": {"particles": 1000, "path": "eager"}}
TINY_MC = {"om.100k.eager.sys": {"lml_gap": 0.5, "posterior_gap": 0.2},
           "sv.100k.graph": {"lml_gap": 1.0, "posterior_gap": 0.3}}


def _run(cell, device, seconds=0.5, program=None):
    return execute(cell, 2 ** 31 + 77, seconds, False, device,
                   time.perf_counter(), program=program)


def _tiny(name):
    cell = Cell(name)
    cell.traffic.update(TINY[name], check_runs=2)
    cell.traffic["limits"] = dict(cell.traffic["limits"], **TINY_MC[name])
    return cell


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_program_passes_at_tiny_size(name):
    result = _run(_tiny(name), "cpu")
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", sorted(TINY))
def test_fault_comes_out_not_correct(name, fault):
    cell = _tiny(name)
    with planted(cell, fault):
        result = _run(cell, "cpu")
    assert not result["correct"], result["checks"]
    if fault in CAUGHT_BY:
        got = result["checks"][CAUGHT_BY[fault]]
        assert got["value"] > got["limit"], got


# --- on the card, at each cell's own size and path --------------------------

@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_on_card_sound_passes_faults_and_control_fail(card, name):
    from smcbench.reference.control import Control
    assert _run(Cell(name), card, 2.0)["correct"]
    for fault in FAULTS:
        cell = Cell(name)
        with planted(cell, fault):
            result = _run(cell, card, 1.0)
        assert not result["correct"], (fault, result["checks"])
        if fault in CAUGHT_BY:
            got = result["checks"][CAUGHT_BY[fault]]
            assert got["value"] > got["limit"], (fault, got)
    control = _run(Cell(name), card, 2.0,
                   program=lambda c, g, s: Control(c, g, s, torch.bfloat16))
    assert not control["correct"], control["checks"]
