"""pna — 4 layers d_hidden=75, aggregators mean-max-min-std, scalers
identity-amplification-attenuation [arXiv:2004.05718; paper]."""
from ..models.gnn.pna import PNAConfig
from .gnn_common import SHAPES, SKIP_SHAPES  # noqa: F401

FAMILY = "gnn"
MODEL = "pna"


def make_config(d_in=75, n_classes=16, graph_level=False, **kw):
    return PNAConfig(name="pna", n_layers=4, d_hidden=75, d_in=d_in,
                     n_classes=n_classes, graph_level=graph_level, **kw)


def smoke_config():
    return PNAConfig(name="pna-smoke", n_layers=2, d_hidden=12, d_in=8,
                     n_classes=4)
