"""Grok-1 314B [moe] — 8 experts top-2, GQA. [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ModelConfig, MoESpec, register


def full() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=32768, vocab_size=131072, head_dim=128,
        moe=MoESpec(num_experts=8, top_k=2, d_ff=32768),
        rope="rope", source="hf:xai-org/grok-1",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
        moe=MoESpec(num_experts=4, top_k=2, d_ff=512))


register("grok-1-314b", full, smoke)
