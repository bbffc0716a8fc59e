"""Model / input-shape configuration system.

Every assigned architecture registers a full production config (exercised
only via the abstract dry-run) and a reduced smoke config (2 layers,
d_model<=512, <=4 experts) that runs a real step on CPU.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional


# storage format of serverless expert slot banks (the bytes every cold
# start moves and every GB-s of residency bills):
#   fp32 — native parameter dtype (no quantization; name matches the
#          smoke configs' float32 serving dtype)
#   int8 — symmetric per-expert-row-scale int8 (the reference's
#          repro/kernels/quant.py; the port's int8 slice is later work):
#          ~0.25x the bank bytes, dequantized inside the kernel tile loop
SLOT_DTYPES = ("fp32", "int8")


@dataclass(frozen=True)
class MoESpec:
    """Mixture-of-Experts sublayer spec."""
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden width
    every_n_layers: int = 1        # MoE replaces FFN every n-th layer (Jamba: 2)
    capacity_factor: float = 1.25  # token capacity per expert = cf * T * k / E
    router_jitter: float = 0.0
    # MoEless serverless-expert control plane (paper §3-4)
    max_replica_slots: int = 0     # 0 => num_experts (no over-provisioning)
    # expert slot-bank storage format (see SLOT_DTYPES above); threads
    # end to end: ExpertRuntime bank layout, the dequantizing kernel
    # family, and the analytic cost model's expert_bytes all derive
    # from this one knob
    slot_dtype: str = "fp32"


@dataclass(frozen=True)
class ServingSpec:
    """Serving-layer KV management knobs (``repro_torch.serving.kv`` /
    ``repro_torch.serving.engine``).

    kv="paged" replaces the per-slot contiguous KV rows with a global
    pool of fixed-size blocks (``kv_block`` tokens each) addressed by
    per-slot block tables — the unit of sharing, copy-on-write, and
    eviction. ``prefill_chunk`` > 0 (paged only) folds prompt prefill
    into the batched decode step, ``prefill_chunk`` tokens per request
    per iteration, instead of a solo B=1 prefill that stalls the whole
    decode batch. ``prefix_cache`` (paged + chunked only) keeps a radix
    cache of prompt-prefix block chains so a shared system prompt is
    refcount-shared instead of re-prefilled."""
    kv: str = "contiguous"         # "contiguous" | "paged"
    kv_block: int = 16             # tokens per KV block (paged)
    kv_blocks: int = 0             # pool size in blocks (0 = auto:
    #                                1 trash + num_slots * blocks/slot)
    prefill_chunk: int = 0         # >0: chunked prefill inside the
    #                                batched step (paged only)
    prefix_cache: bool = False     # radix shared-prefix cache (paged +
    #                                chunked only)


@dataclass(frozen=True)
class SSMSpec:
    """Mamba / xLSTM recurrent sublayer spec."""
    kind: str = "mamba"            # "mamba" | "xlstm"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # xlstm: blocks alternate sLSTM / mLSTM
    slstm_every: int = 2           # every 2nd block is sLSTM, rest mLSTM


@dataclass(frozen=True)
class EncDecSpec:
    num_encoder_layers: int
    encoder_seq_len: int = 1500    # whisper: 30 s of audio at 50 Hz after conv
    frontend: str = "stub"         # modality frontend is a stub per spec


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | vlm | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                      # dense-FFN hidden width (0 for pure SSM)
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    encdec: Optional[EncDecSpec] = None
    serving: ServingSpec = ServingSpec()
    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    rope: str = "rope"             # rope | mrope | none (learned/sinusoidal)
    rope_theta: float = 1e6
    sliding_window: int = 0        # 0 => full attention
    # hybrid layout: one attention layer every n layers, rest SSM (Jamba 1:7 -> 8)
    attn_every_n: int = 1
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # kernel backend for the serving hot spots (expert FFN, decode
    # attention): auto | cuda | ref — resolved by repro_torch.kernels.ops
    # (auto = the CUDA kernels for CUDA tensors, plain torch on the CPU)
    impl: str = "auto"
    source: str = ""               # citation bracket from the assignment

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables padded to a multiple of 128 so the vocab
        dim shards over the model axis; pad logits are masked to -inf."""
        return ((self.vocab_size + 127) // 128) * 128

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def num_params(self) -> int:
        """Total parameter count (approximate, matches init exactly)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def num_active_params(self) -> int:
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

_ARCH_MODULES = [
    "qwen3_32b", "grok_1_314b", "jamba_v01_52b", "qwen2_vl_2b",
    "stablelm_12b", "qwen2_72b", "command_r_plus_104b", "xlstm_125m",
    "whisper_base", "llama4_maverick_400b_a17b",
    # the paper's own evaluation models
    "mixtral_8x7b", "phi35_moe",
]

_REGISTRY: dict[str, "tuple"] = {}


def register(arch_id: str, full, smoke) -> None:
    _REGISTRY[arch_id] = (full, smoke)


def _load_all() -> None:
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; "
                       f"known: {sorted(_REGISTRY)}")
    full, smoke_cfg = _REGISTRY[arch_id]
    return smoke_cfg() if smoke else full()


def get_input_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
