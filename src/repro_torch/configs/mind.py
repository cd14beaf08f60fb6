"""mind — embed_dim=64 n_interests=4 capsule_iters=3 multi-interest
[arXiv:1904.08030; unverified].  Item table 10^7 x 64."""
from ..models.recsys.mind import MINDConfig

FAMILY = "recsys"

SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}
SKIP_SHAPES = {}


def make_config(**kw):
    return MINDConfig(name="mind", n_items=10_000_000, embed_dim=64,
                      n_interests=4, capsule_iters=3, hist_len=50, **kw)


MICROBATCHES = {"train_batch": 4}


def smoke_config():
    return MINDConfig(name="mind-smoke", n_items=1000, embed_dim=16,
                      n_interests=4, capsule_iters=3, hist_len=10)
