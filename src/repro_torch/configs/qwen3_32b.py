"""Qwen3-32B [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
        d_ff=25600, vocab_size=151936, head_dim=128,
        qk_norm=True, qkv_bias=False, rope="rope", rope_theta=1e6,
        source="hf:Qwen/Qwen3-8B",
    )


def smoke() -> ModelConfig:
    return full().with_(num_layers=2, d_model=256, num_heads=4,
                        num_kv_heads=2, d_ff=512, vocab_size=512, head_dim=64)


register("qwen3-32b", full, smoke)
