"""The lower-precision control at a size a test run holds: a tiny run of
each configuration on the CPU, whose samples are also computed by the
reference in float8 e4m3 (weights per tensor, products' inputs per row)
put in the program's place. The control fails the configuration's limits
where the served bfloat16 program passes them. On the card, at the cells'
own sizes, ``tools/control.py`` reads the same numbers."""
from pathlib import Path

import pytest

from perfbench.harness import check
from perfbench.harness.cell import run_cell
from perfbench.tests.tiny import QWEN2, RESNET

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell,over", [("resnet50.poisson", RESNET),
                                       ("qwen2-0.5b.decode", QWEN2)])
def test_the_control_fails_where_the_program_passes(cell, over):
    out = run_cell(ROOT, cell, 2 ** 31 + 5, 2, False, device="cpu",
                   overrides=over, control=True)
    limits = over["sizes"]["limits"]
    assert out.result["correct"], out.result["checks"]
    assert out.control["rows"] == out.program["rows"] > 0
    assert not check.passed(check.checks(out.control, limits, 0))
    assert out.control_correct is False
    assert out.control["logit_err"] > 3 * out.program["logit_err"]
