"""Whisper-base [audio] — enc-dec transformer backbone; the mel+conv
frontend is a stub providing precomputed frame embeddings. [arXiv:2212.04356]"""
from repro_torch.configs.base import EncDecSpec, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
        d_ff=2048, vocab_size=51865,
        encdec=EncDecSpec(num_encoder_layers=6, encoder_seq_len=1500),
        rope="none", norm="layernorm", act="gelu",
        source="arXiv:2212.04356",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        d_ff=512, vocab_size=512,
        encdec=EncDecSpec(num_encoder_layers=2, encoder_seq_len=64))


register("whisper-base", full, smoke)
