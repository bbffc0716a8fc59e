"""Phi-3.5-MoE [moe] — the paper's 16-expert evaluation model (§6.1 Table 1).
[arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig, MoESpec, register


def full() -> ModelConfig:
    return ModelConfig(
        name="phi-3.5-moe", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=6400, vocab_size=32064, head_dim=128,
        moe=MoESpec(num_experts=16, top_k=2, d_ff=6400),
        rope="rope", source="arXiv:2404.14219",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
        moe=MoESpec(num_experts=4, top_k=2, d_ff=512))


register("phi-3.5-moe", full, smoke)
