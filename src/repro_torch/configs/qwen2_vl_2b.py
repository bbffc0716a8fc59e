"""Qwen2-VL-2B [vlm] — M-RoPE, dynamic resolution; vision frontend is a
stub providing precomputed patch embeddings. [arXiv:2409.12191]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        d_ff=8960, vocab_size=151936, head_dim=128,
        qkv_bias=True, rope="mrope", rope_theta=1e6,
        source="arXiv:2409.12191",
    )


def smoke() -> ModelConfig:
    return full().with_(num_layers=2, d_model=256, num_heads=4,
                        num_kv_heads=2, d_ff=512, vocab_size=512, head_dim=64)


register("qwen2-vl-2b", full, smoke)
