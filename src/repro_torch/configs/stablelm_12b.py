"""StableLM-12B [dense] — GQA. [hf:stabilityai/stablelm-2-1_6b family]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", family="dense",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        d_ff=13824, vocab_size=100352, head_dim=160,
        norm="layernorm", act="swiglu", rope="rope", rope_theta=1e4,
        source="hf:stabilityai/stablelm-2-1_6b",
    )


def smoke() -> ModelConfig:
    return full().with_(num_layers=2, d_model=256, num_heads=4,
                        num_kv_heads=2, d_ff=512, vocab_size=512, head_dim=64)


register("stablelm-12b", full, smoke)
