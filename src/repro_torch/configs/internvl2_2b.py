"""InternVL2-2B — InternViT vision encoder + InternLM2 language backbone —
the port's copy of ``repro/configs/internvl2_2b.py``.  [arXiv:2404.16821]
Backbone: 24L, d_model=2048, 16H (GQA kv=8), d_ff=8192, vocab=92553.

The ViT and its projector are stubs, as in the reference: the backbone
takes the merged patch + text embedding stream (B, S, d_model)
(``models/frontend.py``), has no embedding table and an untied head.
No MoE."""
from repro_torch.core.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92553,
    block_pattern=("attn",),
    attention=AttentionConfig(num_heads=16, num_kv_heads=8,
                              rope_theta=1_000_000.0),
    frontend="vision",
    act="swiglu",
    source="InternVL2 [arXiv:2404.16821]",
)
