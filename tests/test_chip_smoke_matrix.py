"""chip_smoke.py's correctness matrix (phase 4) on the CPU backend: every
check at the sizes the on-device run uses."""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("_chip_smoke_matrix", REPO / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


@pytest.mark.parametrize("check", cs.MATRIX, ids=lambda f: f.__name__.removeprefix("check_"))
def test_matrix_check(check):
    chk = cs.Checks()
    check(chk)
    assert chk.count > 0 and not chk.failed, chk.failed
