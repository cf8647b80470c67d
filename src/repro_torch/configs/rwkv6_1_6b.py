"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay — the
port's copy of ``repro/configs/rwkv6_1_6b.py``.  [arXiv:2404.05892]  24L,
d_model=2048, d_ff=7168, vocab=65536.

Every layer is an ``rwkv`` block: the RWKV-6 time mix (32 heads of 64,
chunked scan of 128 tokens) and a ReLU MLP as the channel mix.  No MoE,
no attention; sub-quadratic (a recurrent state per layer)."""
from repro_torch.core.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rwkv=RWKVConfig(head_dim=64, chunk_size=128, decay_lora=64, mix_lora=32),
    act="relu",
    source="Finch: RWKV-6 [arXiv:2404.05892]",
)
