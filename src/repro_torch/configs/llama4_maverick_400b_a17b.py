"""Llama-4 Maverick 400B-A17B — interleaved dense/MoE, 128 experts top-1,
one shared expert — the port's copy of
``repro/configs/llama4_maverick_400b_a17b.py``.
[hf:meta-llama/Llama-4-Scout-17B-16E family]  48L, d_model=5120, 40H (GQA
kv=8), qk-norm, expert d_ff=8192, vocab=202048.

The published depth does not fit one card (18.55B parameters a
``("dense", "moe")`` period); ``chip_smoke.py`` serves one period."""
from repro_torch.core.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("dense", "moe"),     # interleave_moe_layer_step = 2
    attention=AttentionConfig(num_heads=40, num_kv_heads=8, qk_norm=True,
                              rope_theta=500_000.0),
    moe=MoEConfig(num_experts=128, top_k=1, gate="switch",
                  capacity_factor=1.25, d_ff_expert=8192,
                  num_shared_experts=1, dispatch="sort", a2a="auto",
                  overlap_chunks="auto", grouped_block_m="auto",
                  grouped_ep_bound_factor="auto",
                  # the one field that differs from the reference preset,
                  # as in configs/hetumoe_paper_16e.py
                  use_pallas_gate=True),
    act="swiglu",
    source="Llama 4 [hf:meta-llama/Llama-4-Scout-17B-16E]",
)
