"""PyTorch port, ``launch/train_moe.py`` against the reference's
``examples/train_moe.py`` config and ``training.train_loop.train`` on the
CPU, both started from one checkpoint (the reference's initial weights,
written by the reference; the two packages share the format):

* the parameter count equals the reference's ``count_params_analytic``
  exactly, and the config is the example's;
* the 20 losses at float32 (the example's config at float32 in both):
  the first within 1e-5 (``test_torch_training.py``'s GRAD_TOL) and
  every one within rtol 1e-3 (observed
  3e-4: AdamW's first steps move an element by up to 2 lr wherever its
  gradient is near float32 noise, and a route that flips near a tie
  moves a loss by ~1e-3 of itself later on); at bfloat16, the example's
  own dtype, within rtol 1e-2 (observed 1.5e-3: two packages' bf16
  products round differently);
* the loss drops; a second run on the same path resumes at the end and
  trains nothing, where the reference's script fails its own assertion
  on an empty loss list; a second run of twice the steps trains the
  second half.
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import MoESpec as JMoESpec
from repro.models import model as JM
from repro.training import checkpoint as JC
from repro.training.train_loop import train as jtrain
from repro_torch.launch import train_moe as TM

torch.set_num_threads(2)

STEPS = 20
RTOL = {"float32": 1e-3, "bfloat16": 1e-2}
FIRST_TOL = 1e-5


def _jcfg(dtype=None):
    cfg = jget_config("grok-1-314b", smoke=True).with_(
        num_layers=2, d_model=192, num_heads=4, num_kv_heads=2,
        head_dim=48, d_ff=384, vocab_size=4096,
        moe=JMoESpec(num_experts=4, top_k=2, d_ff=384), impl="ref")
    return cfg if dtype is None else cfg.with_(dtype=dtype)


def test_config_and_param_count_match_reference():
    cfg, jcfg = TM.config(), _jcfg()
    for k in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "dtype"):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff) == (4, 2, 384)
    assert TM.run.__kwdefaults__["steps"] == 200
    n = JM.count_params_analytic(jcfg)
    from repro_torch.models.model import count_params_analytic
    assert count_params_analytic(cfg) == n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_losses_match_reference_from_one_checkpoint(dtype, tmp_path,
                                                    monkeypatch):
    example = TM.config()
    monkeypatch.setattr(TM, "config", lambda: example.with_(dtype=dtype))
    jcfg = _jcfg(dtype)
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    JC.save(tmp_path / "ref", jp, step=0)
    for ext in (".npz", ".meta.json"):
        shutil.copy(tmp_path / f"ref{ext}", tmp_path / f"port{ext}")
    jres, _ = jtrain(jcfg, steps=STEPS, seq_len=64, global_batch=8, lr=1e-3,
                     log_every=25, checkpoint_path=str(tmp_path / "ref"),
                     checkpoint_every=100)
    lines = []
    got = TM.run(steps=STEPS, checkpoint_path=tmp_path / "port",
                 device="cpu", log=lines.append)
    want = np.asarray(jres.losses)
    have = np.asarray(got.result.losses)
    assert have.shape == want.shape == (STEPS,)
    if dtype == "float32":
        np.testing.assert_allclose(have[0], want[0], atol=FIRST_TOL,
                                   rtol=FIRST_TOL)
    np.testing.assert_allclose(have, want, rtol=RTOL[dtype])
    assert got.n_params == JM.count_params_analytic(jcfg)
    assert got.last < got.first
    assert got.cv.shape == (2,) and np.isfinite(got.cv).all()
    assert lines[0] == (f"model: {got.n_params / 1e6:.1f}M params "
                        f"(4 experts top-2)")
    assert lines[-2].startswith("\nloss: ")
    assert lines[-1].startswith("final expert-load CV per layer: ")


def test_second_run_resumes(tmp_path):
    path = tmp_path / "ck"
    first = TM.run(steps=STEPS, checkpoint_path=path, device="cpu",
                   log=lambda _: None)
    assert first.last < first.first and len(first.result.losses) == STEPS
    for name in ("ck.npz", "ck.meta.json", "ck.opt.npz"):
        assert (tmp_path / name).exists(), name
    lines = []
    again = TM.run(steps=STEPS, checkpoint_path=path, device="cpu",
                   log=lines.append)
    assert again.result.losses == [] and again.first is None
    assert lines[-1] == (f"\nresumed from {path} at step {STEPS}: no step "
                         "left to train")
    more = TM.run(steps=2 * STEPS, checkpoint_path=path, device="cpu",
                  log=lambda _: None)
    assert len(more.result.losses) == STEPS


def test_main_on_the_cpu(tmp_path, capsys):
    out = TM.main(["--device", "cpu", "--steps", "12", "--batch", "4",
                   "--seq-len", "32", "--checkpoint", str(tmp_path / "m")])
    text = capsys.readouterr().out
    assert "model: 3.6M params (4 experts top-2)" in text
    assert "\nloss: " in text and "steps/s)" in text
    assert len(out.result.losses) == 12
    assert (tmp_path / "m.npz").exists()


def test_main_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.main(["--checkpoint", str(tmp_path / "c")])
