"""The four GNN models at their configurations' full widths
(``make_config``: GIN 5 x 64, GatedGCN 16 x 70, PNA 4 x 75, DimeNet 6
blocks x 128 with 8 bilinear, 7 spherical and 6 radial) on the 60-node
graph against the JAX package, on the CPU: forward, loss, gradients and
one AdamW update, node level, and DimeNet's graph-level regression, at
``tests/test_torch_gnn.py``'s tolerances."""
import pytest

from release_xla import release_compiled  # noqa: F401
from test_torch_gnn import check_case
from torch_gnn_common import ARCHS


@pytest.mark.parametrize("arch,graph_level", [
    *((a, False) for a in ARCHS), ("dimenet", True)])
def test_full_width_matches_reference(arch, graph_level):
    check_case(arch, "full", graph_level)
