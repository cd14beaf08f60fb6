"""phi4-mini-3.8b — 32L d_model=3072 24H (GQA kv=8, head_dim=128)
d_ff=8192, vocab=200064, RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
import torch
from ..models.transformer import LMConfig
from .lm_common import SHAPES, SKIP_SHAPES  # noqa: F401

FAMILY = "lm"


def make_config(**kw):
    return LMConfig(
        name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
        n_kv=8, head_dim=128, d_ff=8192, vocab=200064, mlp="swiglu", tied_embed=True, **kw)


MICROBATCHES = {"train_4k": 4}


def smoke_config():
    return LMConfig(
        name="phi4-smoke", n_layers=2, d_model=96, n_heads=6, n_kv=2,
        head_dim=16, d_ff=256, vocab=256, mlp="swiglu", dtype=torch.float32)
