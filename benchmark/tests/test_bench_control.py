"""The control: the reference in the program's place, its encode one
precision lower (float32 for the configurations' float64), at each
cell's own batch and degree, has to come out not correct; the reference
in float64 in the same place comes out correct."""

import numpy as np
import pytest

from benchmark import check, control
from benchmark.catalog import Catalog
from benchmark.tests import copies


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """The cells of BENCHMARK.json and the asym cell."""
    return copies.copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", Catalog().cells() + ["n4096.asym.b1024"])
def test_the_control_is_not_correct(catalog, cell):
    nums = control.control(catalog, cell, 2 ** 31 + 7, calls=40)
    assert not check.correct(nums)
    assert nums["coeff_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", ["n4096.sym.b1024", "n4096.asym.b1024"])
def test_the_reference_in_the_programs_place_is_correct(catalog, cell):
    nums = control.control(catalog, cell, 5, calls=40, dtype=np.float64)
    assert check.correct(nums)


def test_the_control_command_exits_zero_when_every_seed_fails(capsys):
    assert control.main(["--workload", "n4096.sym.b16", "--seeds", "1", "2",
                         "3", "--calls", "10"]) == 0
    assert capsys.readouterr().out.count('"correct": false') == 3
