"""Finds a cell's files by name: ``BENCHMARK.json`` at the checkout's
root, the cell under ``perfbench/workloads/<cell>.json``, its
configuration under ``perfbench/configs/<config>.json`` and its traffic
under ``perfbench/traffic/<traffic>.json``; and which metrics a run of
the cell reports."""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path

from perfbench.reference.moe_decoder import Arch

PB = Path(__file__).resolve().parent.parent
ROOT = PB.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict          # the configuration file, as run
    cell: dict            # the cell file
    entry: dict           # the cell's entry in BENCHMARK.json
    end_to_end: list      # its end-to-end metric entries
    per_layer: list       # its per-layer metric entries


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
    cell = json.loads((PB / "workloads" / f"{name}.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    return Cell(name, config, cell, entry,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def model_config(config: dict, smoke: bool = False):
    """The port's ``ModelConfig`` of a configuration file: the port's
    registered architecture with the file's ``port`` settings. `smoke`
    takes the architecture's smoke sizes instead (CPU tests)."""
    from repro_torch.configs import get_config
    port = config["port"]
    cfg = get_config(port["arch"], smoke=smoke)
    moe = dataclasses.replace(cfg.moe, **port.get("moe", {}))
    cfg = cfg.with_(num_layers=port.get("smoke_layers", 2) if smoke
                    else port["num_layers"], moe=moe,
                    dtype=port.get("dtype", cfg.dtype))
    if not smoke:
        _check_widths(config, cfg)
    return cfg


# the configuration file's published keys against the port's fields
_WIDTHS = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
           "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
           "vocab_size": "vocab_size", "num_hidden_layers": "num_layers",
           "rope_theta": "rope_theta"}


def _check_widths(config: dict, cfg) -> None:
    """The file states the configuration as run: each of its keys must
    be what the port runs, so that the two cannot drift apart."""
    got = {k: getattr(cfg, f) for k, f in _WIDTHS.items()}
    got.update(intermediate_size=cfg.moe.d_ff,
               num_local_experts=cfg.moe.num_experts,
               num_experts_per_tok=cfg.moe.top_k)
    for k, v in got.items():
        if k in config and config[k] != v:
            raise SystemExit(f"perfbench: {k}={config[k]} in the "
                             f"configuration file, the port runs {v}")


def arch_of(cfg, config: dict) -> Arch:
    """The reference's sizes of the port's config `cfg`."""
    return Arch(d_model=cfg.d_model, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim,
                num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                d_ff=cfg.moe.d_ff, vocab_size=cfg.vocab_size,
                rope_theta=cfg.rope_theta,
                norm_eps=config.get("rms_norm_eps", 1e-6),
                capacity_factor=cfg.moe.capacity_factor,
                expert_format="int8" if cfg.moe.slot_dtype == "int8"
                and config["port"].get("expert_runtime") == "on"
                else "bf16")
