"""Jamba-v0.1 52B [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2 every
2 layers. [arXiv:2403.19887]"""
from repro_torch.configs.base import ModelConfig, MoESpec, SSMSpec, register


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=65536, head_dim=128,
        moe=MoESpec(num_experts=16, top_k=2, d_ff=14336, every_n_layers=2),
        ssm=SSMSpec(kind="mamba", d_state=16, d_conv=4, expand=2),
        attn_every_n=8,  # 1 attention layer per 8 (1:7 attn:mamba)
        rope="none", source="arXiv:2403.19887",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64, attn_every_n=2,
        moe=MoESpec(num_experts=4, top_k=2, d_ff=512, every_n_layers=2),
        ssm=SSMSpec(kind="mamba", d_state=8, d_conv=4, expand=2))


register("jamba-v0.1-52b", full, smoke)
