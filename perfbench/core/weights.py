"""The served model's weights, made by the benchmark from the seed on
the device, in the type they are served in, one seeded draw a stacked
leaf, and laid out as the port takes its parameters (leaves stacked
over layers, ``{embed, layers: [{norm1, attn, norm2, moe}], final_norm,
head}``). The same tensors go to the program and to the reference.

Scales as the published models' initialisation: normal with standard
deviation 0.02 for the embedding and 1 / sqrt(fan-in) for every
projection, norm scales 1."""
from __future__ import annotations

import math

import torch


def make(cfg, seed: int, device) -> dict:
    """Random weights of the decoder `cfg` (an attention + MoE layer
    pattern of one sublayer) from `seed`."""
    dt = getattr(torch, cfg.dtype)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d = cfg.num_layers, cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    e, f, vp = cfg.moe.num_experts, cfg.moe.d_ff, cfg.padded_vocab

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=dev).mul_(std)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)
    sd = 1.0 / math.sqrt(d)
    return {
        "embed": normal((vp, d), 0.02),
        "layers": [{
            "norm1": {"scale": ones((L, d))},
            "attn": {"wq": normal((L, d, h * hd), sd),
                     "wk": normal((L, d, kv * hd), sd),
                     "wv": normal((L, d, kv * hd), sd),
                     "wo": normal((L, h * hd, d), 1.0 / math.sqrt(h * hd))},
            "norm2": {"scale": ones((L, d))},
            "moe": {"router": {"w_gate": normal((L, d, e), sd)},
                    "experts": {"w_gate": normal((L, e, d, f), sd),
                                "w_up": normal((L, e, d, f), sd),
                                "w_down": normal((L, e, f, d),
                                                 1.0 / math.sqrt(f))}},
        }],
        "final_norm": {"scale": ones((d,))},
        "head": normal((d, vp), sd),
    }
