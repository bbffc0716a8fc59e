"""xLSTM-125M [ssm] — alternating sLSTM + mLSTM blocks. [arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig, SSMSpec, register


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        ssm=SSMSpec(kind="xlstm", expand=2, slstm_every=2),
        attn_every_n=0,  # attention-free
        rope="none", norm="layernorm",
        source="arXiv:2405.04517",
    )


def smoke() -> ModelConfig:
    return full().with_(num_layers=2, d_model=256, num_heads=4,
                        num_kv_heads=4, vocab_size=512)


register("xlstm-125m", full, smoke)
