"""Yi-6B — llama-architecture GQA dense model — the port's copy of
``repro/configs/yi_6b.py``.  [arXiv:2403.04652]  32L, d_model=4096, 32H
(GQA kv=4), d_ff=11008, vocab=64000.  No MoE."""
from repro_torch.core.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab_size=64000,
    block_pattern=("attn",),
    attention=AttentionConfig(num_heads=32, num_kv_heads=4,
                              rope_theta=5_000_000.0),
    act="swiglu",
    source="Yi [arXiv:2403.04652]",
)
