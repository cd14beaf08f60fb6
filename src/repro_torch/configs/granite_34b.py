"""granite-34b — 88L d_model=6144 48H (MQA kv=1, head_dim=128) d_ff=24576,
vocab=49152, 2-matrix GELU MLP (gpt_bigcode lineage) [arXiv:2405.04324; hf].

The deep/wide cell: the reference trains it with FSDP + TP + a
sequence-sharded residual stream (Megatron-SP) + gradient accumulation.
``seq_shard`` is set as there; on one card it shards nothing."""
import torch
from ..models.transformer import LMConfig
from .lm_common import SHAPES, SKIP_SHAPES  # noqa: F401

FAMILY = "lm"


def make_config(**kw):
    kw.setdefault("seq_shard", True)
    return LMConfig(
        name="granite-34b", n_layers=88, d_model=6144, n_heads=48, n_kv=1,
        head_dim=128, d_ff=24576, vocab=49152, mlp="gelu", **kw)


MICROBATCHES = {"train_4k": 8}


def smoke_config():
    return LMConfig(
        name="granite34b-smoke", n_layers=3, d_model=64, n_heads=4, n_kv=1,
        head_dim=16, d_ff=256, vocab=256, mlp="gelu", dtype=torch.float32)
