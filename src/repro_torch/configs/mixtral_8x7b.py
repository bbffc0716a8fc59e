"""Mixtral-8x7B [moe] — the paper's primary evaluation model (§6.1 Table 1).
[arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig, MoESpec, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000, head_dim=128,
        moe=MoESpec(num_experts=8, top_k=2, d_ff=14336),
        rope="rope", source="arXiv:2401.04088",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
        moe=MoESpec(num_experts=4, top_k=2, d_ff=512))


register("mixtral-8x7b", full, smoke)
