"""Llama-4-Maverick 400B-A17B [moe] — 128 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E family]"""
from repro_torch.configs.base import ModelConfig, MoESpec, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=8192, vocab_size=202048, head_dim=128,
        # Maverick interleaves MoE with dense FFN every other layer
        # (model card); 24 MoE layers x 128e x 3 x 5120 x 8192 ~= 386B,
        # + dense/attn/embed ~= 400B total as published.
        moe=MoESpec(num_experts=128, top_k=1, d_ff=8192, every_n_layers=2),
        rope="rope", rope_theta=5e5,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
        moe=MoESpec(num_experts=4, top_k=1, d_ff=512))


register("llama4-maverick-400b-a17b", full, smoke)
