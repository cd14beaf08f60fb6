"""qwen3-0.6b — 28L d_model=1024 16H (GQA kv=8, head_dim=128) d_ff=3072,
vocab=151936, qk_norm [hf:Qwen/Qwen3-8B; hf]."""
import torch

from ..models.transformer import LMConfig
from .lm_common import SHAPES, SKIP_SHAPES  # noqa: F401

FAMILY = "lm"


def make_config(**kw):
    return LMConfig(
        name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16, n_kv=8,
        head_dim=128, d_ff=3072, vocab=151936, mlp="swiglu", qk_norm=True,
        rope_theta=1e6, tied_embed=True, **kw)


MICROBATCHES = {}


def smoke_config():
    return LMConfig(
        name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        head_dim=16, d_ff=96, vocab=256, mlp="swiglu", qk_norm=True,
        dtype=torch.float32)
