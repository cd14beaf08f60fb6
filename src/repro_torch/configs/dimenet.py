"""dimenet — n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7 n_radial=6
[arXiv:2003.03123; unverified].

Non-geometric shapes (Cora/products/Reddit) consume synthesized 3D node
positions; the triplet-gather regime is the same."""
from ..models.gnn.dimenet import DimeNetConfig
from .gnn_common import SHAPES, SKIP_SHAPES  # noqa: F401

FAMILY = "gnn"
MODEL = "dimenet"


def make_config(d_in=0, n_classes=1, graph_level=True, **kw):
    return DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6,
                         d_in=d_in, n_out=n_classes,
                         graph_level=graph_level, **kw)


def smoke_config():
    return DimeNetConfig(name="dimenet-smoke", n_blocks=2, d_hidden=16,
                         n_bilinear=2, n_spherical=3, n_radial=2, d_in=8,
                         n_out=1)
