"""Qwen2-72B [dense] — GQA, QKV bias. [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=29568, vocab_size=152064, head_dim=128,
        qkv_bias=True, rope="rope", rope_theta=1e6,
        source="arXiv:2407.10671",
    )


def smoke() -> ModelConfig:
    return full().with_(num_layers=2, d_model=256, num_heads=4,
                        num_kv_heads=2, d_ff=512, vocab_size=512, head_dim=64)


register("qwen2-72b", full, smoke)
