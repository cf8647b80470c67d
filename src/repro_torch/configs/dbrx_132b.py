"""DBRX 132B — fine-grained MoE, 16 experts top-4 every layer — the port's
copy of ``repro/configs/dbrx_132b.py``.  [hf:databricks/dbrx-base]  40L,
d_model=6144, 48H (GQA kv=8), expert d_ff=10752, vocab=100352.

The published depth does not fit one card (4.49B parameters a layer with
the embeddings); ``chip_smoke.py`` serves it at 2 layers."""
from repro_torch.core.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    d_ff=10752,
    vocab_size=100352,
    block_pattern=("moe",),
    attention=AttentionConfig(num_heads=48, num_kv_heads=8,
                              rope_theta=500_000.0),
    moe=MoEConfig(num_experts=16, top_k=4, gate="topk",
                  capacity_factor=1.25, d_ff_expert=10752,
                  dispatch="sort", a2a="auto", overlap_chunks="auto",
                  grouped_block_m="auto", grouped_ep_bound_factor="auto",
                  # the one field that differs from the reference preset,
                  # as in configs/hetumoe_paper_16e.py
                  use_pallas_gate=True),
    act="swiglu",
    source="DBRX [hf:databricks/dbrx-base]",
)
