"""The paper's own benchmark model (§3.2 "Overall Performance"): a
16-expert MoE layer, expert FFN hidden 2048, embedding dim 2048 — the
port's copy of ``repro/configs/hetumoe_paper_16e.py``, modelled as a
2-layer MoE transformer."""
from repro_torch.core.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="hetumoe-paper-16e",
    family="moe",
    num_layers=2,
    d_model=2048,
    d_ff=2048,
    vocab_size=50304,
    block_pattern=("moe",),
    attention=AttentionConfig(num_heads=16, num_kv_heads=16),
    moe=MoEConfig(num_experts=16, top_k=1, gate="switch",
                  capacity_factor=1.25, d_ff_expert=2048,
                  dispatch="sort", a2a="auto", overlap_chunks="auto",
                  grouped_block_m="auto", grouped_ep_bound_factor="auto",
                  # the one field that differs from the reference preset:
                  # the port serves through its hand-written kernels
                  use_pallas_gate=True),
    act="relu",
    source="HetuMoE paper §3.2 (16e, d_ff=2048, seq=1024, d=2048)",
)

# Raw dims for the layer-level benchmarks (Figs. 1/7/8)
PAPER_LAYER = dict(d_model=2048, d_ff=2048, num_experts=16, seq_len=1024)
