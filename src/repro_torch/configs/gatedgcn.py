"""gatedgcn — 16 layers d_hidden=70, gated aggregator
[arXiv:2003.00982; paper]."""
from ..models.gnn.gatedgcn import GatedGCNConfig
from .gnn_common import SHAPES, SKIP_SHAPES  # noqa: F401

FAMILY = "gnn"
MODEL = "gatedgcn"


def make_config(d_in=70, n_classes=16, graph_level=False, **kw):
    return GatedGCNConfig(name="gatedgcn", n_layers=16, d_hidden=70,
                          d_in=d_in, n_classes=n_classes,
                          graph_level=graph_level, **kw)


def smoke_config():
    return GatedGCNConfig(name="gatedgcn-smoke", n_layers=2, d_hidden=12,
                          d_in=8, n_classes=4)
