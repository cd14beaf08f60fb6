"""The port's cell builders against the reference's on the multi-pod
(2, 16, 16) mesh, at full width (``tests/torch_cells_common.py`` says
what is held); the single-pod mesh is ``tests/test_torch_cells.py``."""
import pytest

from release_xla import release_compiled  # noqa: F401
from torch_cells_common import compare_cell, held_cells, \
    port_mesh  # noqa: F401

KIND = "multi"


@pytest.mark.parametrize("cell", held_cells(KIND))
def test_cell_matches_reference(cell, port_mesh):  # noqa: F811
    compare_cell(KIND, cell, port_mesh)


def test_cells_of_the_mesh_held():
    """Every non-MoE cell, and one MoE cell a mesh."""
    held = held_cells(KIND)
    assert len(held) == 31 and "granite-moe-3b-a800m/decode_32k" in held
    single = held_cells("single")
    assert len(single) == 31 and "deepseek-moe-16b/train_4k" in single
