"""Gemma-2 9B — alternating local/global attention, logit softcaps — the
port's copy of ``repro/configs/gemma2_9b.py``.  [arXiv:2408.00118]  42L,
d_model=3584, 16H (GQA kv=8, head_dim=256), d_ff=14336, vocab=256000.

Local layers: sliding window 4096; global layers: full attention (capped
to the local window with ``long_context``); attention-logit softcap 50 and
final-logit softcap 30; GeGLU; tied embeddings scaled by sqrt(d_model).
No MoE."""
from repro_torch.core.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab_size=256000,
    block_pattern=("local", "global"),
    attention=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=256,
                              rope_theta=10_000.0, attn_softcap=50.0),
    local_window=4096,
    final_softcap=30.0,
    act="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
    source="Gemma 2 [arXiv:2408.00118]",
)
