"""Command-R+ 104B [dense] — GQA, no bias. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
        d_ff=33792, vocab_size=256000, head_dim=128,
        qkv_bias=False, norm="layernorm", rope="rope", rope_theta=75e4,
        tie_embeddings=True, source="hf:CohereForAI/c4ai-command-r-v01",
    )


def smoke() -> ModelConfig:
    return full().with_(num_layers=2, d_model=256, num_heads=4,
                        num_kv_heads=2, d_ff=512, vocab_size=512, head_dim=64)


register("command-r-plus-104b", full, smoke)
