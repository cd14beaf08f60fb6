"""deepseek-moe-16b — 28L d_model=2048 16H (MHA kv=16) d_ff=1408/expert,
vocab=102400, MoE: 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf]."""
import torch
from ..models.transformer import LMConfig
from .lm_common import SHAPES, SKIP_SHAPES  # noqa: F401

FAMILY = "lm"


def make_config(**kw):
    return LMConfig(
        name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
        n_kv=16, head_dim=128, d_ff=1408, vocab=102400, mlp="swiglu",
        moe=True, n_experts=64, top_k=6, n_shared=2, **kw)


MICROBATCHES = {"train_4k": 16}
PREFILL_CHUNKS = {"prefill_32k": 8}


def smoke_config():
    return LMConfig(
        name="deepseek-moe-16b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv=4, head_dim=16, d_ff=32, vocab=256, mlp="swiglu",
        moe=True, n_experts=8, top_k=6, n_shared=2, dtype=torch.float32)
