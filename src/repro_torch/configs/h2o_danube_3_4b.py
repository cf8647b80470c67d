"""H2O-Danube-3 4B — llama+mistral mix with sliding-window attention — the
port's copy of ``repro/configs/h2o_danube_3_4b.py``.  [arXiv:2401.16818]
24L, d_model=3840, 32H (GQA kv=8, head dim 3840 / 32 = 120), d_ff=10240,
vocab=32000.  Every layer windowed (4096), so decode runs on ring caches
of the window's length.  No MoE."""
from repro_torch.core.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=("attn",),
    attention=AttentionConfig(num_heads=32, num_kv_heads=8, window=4096,
                              rope_theta=10_000.0),
    act="swiglu",
    source="H2O-Danube3 [arXiv:2401.16818]",
)
