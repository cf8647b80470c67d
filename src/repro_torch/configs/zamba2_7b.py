"""Zamba2-7B — hybrid: a Mamba-2 backbone and one SHARED attention block
— the port's copy of ``repro/configs/zamba2_7b.py``.  [arXiv:2411.15242]
81L, d_model=3584, 32H (kv=32, MHA in the shared block, head dim 112),
d_ff=14336, vocab=32000, ssm_state=64.

Pattern: two ``mamba`` blocks, then a ``mamba_sa`` block (Mamba-2, then
the shared attention: one parameter set reused at all 27 occurrences,
LoRA-adapted per occurrence).  The shared attention is unwindowed, capped
to ``local_window`` (a ring of 4096) in the long-context serving variant.
No MoE."""
from repro_torch.core.config import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("mamba", "mamba", "mamba_sa"),
    attention=AttentionConfig(num_heads=32, num_kv_heads=32,
                              rope_theta=10_000.0),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk_size=128,
                  conv_width=4, n_groups=1),
    local_window=4096,
    act="swiglu",
    source="Zamba2 [arXiv:2411.15242]",
)
