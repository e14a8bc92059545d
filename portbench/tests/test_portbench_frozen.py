"""The frozen reader and injector give what the port's own give."""

import numpy as np
import pytest

from portbench.cell import ROOT
from portbench.frozen import g2o, outliers

DATASETS = ("INTEL", "M3500")


@pytest.mark.parametrize("name", DATASETS)
def test_reader_matches_port(name):
    from slam_tpu_torch.io import g2o as port_g2o

    mine = g2o.read(str(ROOT / "data" / f"{name}.g2o"))
    port = port_g2o.load_g2o(str(ROOT / "data" / f"{name}.g2o"),
                             use_native=False)
    np.testing.assert_array_equal(mine.poses, port.poses)
    np.testing.assert_array_equal(mine.ij, port.edges_ij)
    np.testing.assert_array_equal(mine.meas, port.edges_meas)
    np.testing.assert_array_equal(mine.info, port.edges_info)
    np.testing.assert_array_equal(mine.etype, port.edge_type)


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("seed", range(8))
def test_injector_matches_port(name, seed):
    from slam_tpu_torch.io import g2o as port_g2o

    base = g2o.read(str(ROOT / "data" / f"{name}.g2o"))
    mine = outliers.add_bogus_loops(base, 50, seed)
    port = port_g2o.load_g2o(str(ROOT / "data" / f"{name}.g2o"),
                             use_native=False).add_random_outliers(50, seed)
    np.testing.assert_array_equal(mine.ij, port.edges_ij)
    np.testing.assert_array_equal(mine.meas, port.edges_meas)
    np.testing.assert_array_equal(mine.info, port.edges_info)
    np.testing.assert_array_equal(mine.etype, port.edge_type)
