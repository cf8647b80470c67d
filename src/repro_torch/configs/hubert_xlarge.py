"""HuBERT X-Large — encoder-only audio transformer (wav2vec 2.0
architecture) — the port's copy of ``repro/configs/hubert_xlarge.py``.
[arXiv:2106.07447]  48L, d_model=1280, 16H (kv=16, MHA), d_ff=5120,
vocab=504 (cluster targets).

The conv feature extractor and its conv positional embedding are stubs,
as in the reference: the backbone takes frame embeddings (B, S, d_model)
(``models/frontend.py``).  Encoder-only: bidirectional attention, no
RoPE, no decode step.  No MoE."""
from repro_torch.core.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    block_pattern=("attn",),
    attention=AttentionConfig(num_heads=16, num_kv_heads=16, use_rope=False,
                              causal=False),
    encoder_only=True,
    frontend="audio",
    act="gelu",
    source="HuBERT [arXiv:2106.07447]",
)
