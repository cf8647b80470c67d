"""StarCoder2-3B — GQA + RoPE code model — the port's copy of
``repro/configs/starcoder2_3b.py``.  [arXiv:2402.19173]  30L,
d_model=3072, 24H (GQA kv=2), d_ff=12288, vocab=49152.  A classic 4×d
MLP (tanh-GELU, not gated).  No MoE."""
from repro_torch.core.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    d_ff=12288,
    vocab_size=49152,
    block_pattern=("attn",),
    attention=AttentionConfig(num_heads=24, num_kv_heads=2,
                              rope_theta=999_999.0),
    act="gelu",
    source="StarCoder2 [arXiv:2402.19173]",
)
