"""The CSAIL and M3500 cells of ``results/ceres_oracle.json`` through the
port (``test_torch_ceres_oracle.py`` says how, and runs the INTEL
cells): each within 1e-7 relative of the oracle's recorded final cost."""

import pytest

from test_torch_ceres_oracle import PORTED, _cell_id, check_cell
from test_torch_ceres_oracle import two_threads  # noqa: F401  (fixture)

OTHERS = [k for k in PORTED if k[0] != "INTEL"]


def test_cells_are_csail_and_m3500():
    assert sorted({k[0] for k in OTHERS}) == ["CSAIL", "M3500"]
    assert len(OTHERS) == 4


@pytest.mark.parametrize("key", OTHERS, ids=_cell_id)
def test_oracle_cell_through_the_port(key):
    check_cell(key)
