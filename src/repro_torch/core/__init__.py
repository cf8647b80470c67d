"""Config, gating, capacity, layout, tuning and the MoE layer."""
