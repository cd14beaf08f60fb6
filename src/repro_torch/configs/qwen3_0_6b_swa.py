"""BONUS: qwen3-0.6b with sliding-window attention (window=4096) — the
sub-quadratic variant that makes the long_500k cell lowerable."""
import torch

from ..models.transformer import LMConfig
from .lm_common import SHAPES  # noqa: F401

FAMILY = "lm"
SKIP_SHAPES = {"train_4k": "bonus arch: long-context cell only",
               "prefill_32k": "bonus arch: long-context cell only",
               "decode_32k": "bonus arch: long-context cell only"}


def make_config(**kw):
    return LMConfig(
        name="qwen3-0.6b-swa", n_layers=28, d_model=1024, n_heads=16,
        n_kv=8, head_dim=128, d_ff=3072, vocab=151936, mlp="swiglu",
        qk_norm=True, rope_theta=1e6, attn_window=4096,
        tied_embed=True, **kw)


MICROBATCHES = {}


def smoke_config():
    return LMConfig(
        name="qwen3-swa-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        head_dim=16, d_ff=96, vocab=256, mlp="swiglu", qk_norm=True,
        attn_window=8, dtype=torch.float32)
