"""gin-tu — GIN, 5 layers d_hidden=64, sum aggregator, learnable eps
[arXiv:1810.00826; paper]."""
from ..models.gnn.gin import GINConfig
from .gnn_common import SHAPES, SKIP_SHAPES  # noqa: F401

FAMILY = "gnn"
MODEL = "gin"


def make_config(d_in=64, n_classes=16, graph_level=False, **kw):
    return GINConfig(name="gin-tu", n_layers=5, d_hidden=64, d_in=d_in,
                     n_classes=n_classes, graph_level=graph_level, **kw)


def smoke_config():
    return GINConfig(name="gin-smoke", n_layers=2, d_hidden=16, d_in=8,
                     n_classes=4)
