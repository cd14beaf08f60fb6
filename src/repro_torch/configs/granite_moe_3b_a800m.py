"""granite-moe-3b-a800m — 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert,
vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

40 experts don't divide the 16-wide model axis -> expert-TP fallback
(d_ff sharded inside each expert; see parallel/sharding.py)."""
import torch
from ..models.transformer import LMConfig
from .lm_common import SHAPES, SKIP_SHAPES  # noqa: F401

FAMILY = "lm"


def make_config(**kw):
    return LMConfig(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv=8, head_dim=64, d_ff=512, vocab=49155, mlp="swiglu",
        moe=True, n_experts=40, top_k=8, n_shared=0, **kw)


MICROBATCHES = {"train_4k": 16}
PREFILL_CHUNKS = {"prefill_32k": 8}


def smoke_config():
    return LMConfig(
        name="granite-moe-smoke", n_layers=2, d_model=48, n_heads=4,
        n_kv=2, head_dim=12, d_ff=32, vocab=255, mlp="swiglu",
        moe=True, n_experts=5, top_k=3, n_shared=0, dtype=torch.float32)
