"""The port's cell builders against the reference's on the single-pod
(16, 16) mesh, at full width (``tests/torch_cells_common.py`` says what
is held); the multi-pod mesh is ``tests/test_torch_cells_multi.py``."""
import pytest

from release_xla import release_compiled  # noqa: F401
from torch_cells_common import compare_cell, held_cells, port_mesh, \
    registry_covers_reference  # noqa: F401

KIND = "single"


@pytest.mark.parametrize("cell", held_cells(KIND))
def test_cell_matches_reference(cell, port_mesh):  # noqa: F811
    compare_cell(KIND, cell, port_mesh)


def test_registry_covers_the_reference_cells():
    registry_covers_reference()
