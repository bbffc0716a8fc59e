"""PyTorch port, the encoder-decoder stack (whisper-base) and gelu FFNs,
dense and expert, against the JAX reference on the reference's own
float32 weights (smoke configs).

The oracle of decode. The reference's ``decode_step`` reads
``batch['enc_out']`` but applies no cross-attention (its pattern comes
from ``layer_pattern``, which has none; only ``forward`` and
``init_params`` swap in the cross-attention pattern), and it gives every
token of a multi-token step the sinusoid of position ``cache_len``. So
its prefill into a cache and its decode differ from its own ``forward``
(``test_reference_decode_step_ignores_enc_out`` and
``test_reference_prefill_into_cache_strays_from_its_forward`` pin both).
The port's prefill into a cache, its decode steps and its fixed-batch
API are held to the reference's ``forward`` on the same sequence.

Tolerance: floats atol = rtol = 1e-4 (float32 through a few layers,
sums taken in different orders), as ``tests/test_torch_model.py``; the
sinusoids 1e-6. Exact: greedy tokens, ``expert_load``, ``dropped``, tree
keys and shapes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JInputShape
from repro.kernels import quant as JQ
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.expert_runtime import ExpertRuntime as JExpertRuntime
from repro_torch.configs import ServingSpec, get_config
from repro_torch.configs.base import InputShape
from repro_torch.distributed import ep as EP
from repro_torch.kernels import quant as Q
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.expert_runtime import ExpertRuntime
from repro_torch.serving.kv import PagedKVCache
from repro_torch.serving.scheduler import GenRequest

torch.set_num_threads(1)

TOL = 1e-4
ARCH = "whisper-base"
_jinit = jax.jit(JM.init_params, static_argnums=0)


@functools.lru_cache(maxsize=None)
def _setup(arch=ARCH, act=None):
    """Float32 smoke configs of both packages (optionally at another
    `act`) and the reference's weights in both forms (read-only: no test
    writes to them)."""
    cfg = get_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    jcfg = jget_config(arch, smoke=True).with_(dtype="float32", impl="ref")
    if act is not None:
        cfg, jcfg = cfg.with_(act=act), jcfg.with_(act=act)
    jp = _jinit(jcfg, jax.random.PRNGKey(3))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def _inputs(cfg, b=2, s=8, seed=0):
    """Seeded tokens (B, S) int32 and frame embeddings (B, T, D)
    float32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    emb = (rng.standard_normal((b, cfg.encdec.encoder_seq_len,
                                cfg.d_model)) * 0.02).astype(np.float32)
    return toks, emb


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _jforward(s=8):
    """The reference's ``forward`` logits on `_inputs` cut to `s`
    tokens."""
    _, jcfg, jp, _ = _setup()
    toks, emb = _inputs(get_config(ARCH, smoke=True))
    jl, _ = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks[:, :s]),
                                  "enc_embeds": jnp.asarray(emb)})
    return np.asarray(jl)


# ---------------------------------------------------------------- params

# the config, field by field against the reference's (full and smoke):
# tests/test_torch_model.py::test_configs_equal_reference_field_by_field


@pytest.mark.parametrize("smoke", [True, False])
def test_param_tree_keys_and_shapes_equal_reference(smoke):
    """The port's seeded init builds the reference's tree (encoder
    layers, cross-attention and its norm on every decoder sublayer, gelu
    FFNs without w_gate), and ``count_params_analytic`` counts it."""
    cfg, jcfg = get_config(ARCH, smoke=smoke), jget_config(ARCH, smoke=smoke)
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        JM.abstract_params(jcfg))
    mine = T.init_params(cfg, 0, torch.device("cpu"))
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).split(".")[-1]), mine)
    assert got == want
    assert "w_gate" not in mine["layers"][0]["ffn"]
    assert set(mine["layers"][0]) == {"norm1", "attn", "norm_x", "xattn",
                                      "norm2", "ffn"}
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)


def test_from_jax_carries_the_encdec_tree():
    cfg, _, jp, tp = _setup()
    for path, ref in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for k in path:
            t = t[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref),
                                      err_msg=str(path))
    assert len(tp["encoder"]["layers"]) == 1
    assert tp["encoder"]["layers"][0]["attn"]["wq"].shape[0] == \
        cfg.encdec.num_encoder_layers


@pytest.mark.parametrize("d", [256, 512])
def test_sinusoids_equal_reference(d):
    """Within 1e-6: 1500 positions (whisper's frames), and single
    positions as ``decode_step`` adds them."""
    np.testing.assert_allclose(
        T._sinusoidal(1500, d, "cpu").numpy(),
        np.asarray(JT._sinusoidal(1500, d)), atol=1e-6, rtol=0)
    for p in (0, 7, 63, 1499):
        np.testing.assert_allclose(
            T._sinusoidal_at(torch.tensor(p), d).numpy(),
            np.asarray(JT._sinusoidal_at(p, d)).reshape(d), atol=1e-6,
            rtol=0)


# ---------------------------------------------------------------- forward


def test_run_encoder_equals_reference():
    cfg, jcfg, jp, tp = _setup()
    _, emb = _inputs(cfg)
    je = JT._run_encoder(jcfg, jp, {"enc_embeds": jnp.asarray(emb)})
    _close(T.run_encoder(cfg, tp, torch.from_numpy(emb)), je, "encoder")


def test_forward_with_enc_embeds_equals_reference():
    cfg, _, _, tp = _setup()
    toks, emb = _inputs(cfg)
    tl, tm = T.forward(cfg, tp, {"tokens": torch.from_numpy(toks),
                                 "enc_embeds": torch.from_numpy(emb)})
    _close(tl, _jforward(), "forward logits")
    assert float(tm["aux_loss"]) == 0.0


def test_loss_fn_equals_reference():
    cfg, jcfg, jp, tp = _setup()
    toks, emb = _inputs(cfg)
    labels = np.roll(toks, -1, axis=1)
    jt, jm = JM.loss_fn(jcfg, jp, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels),
                                   "enc_embeds": jnp.asarray(emb)})
    tt, tm = M.loss_fn(cfg, tp, {"tokens": torch.from_numpy(toks),
                                 "labels": torch.from_numpy(labels),
                                 "enc_embeds": torch.from_numpy(emb)})
    _close(tt, jt, "total")
    _close(tm["loss"], jm["loss"], "loss")


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_input_specs_audio_keys_equal_reference(kind):
    """A decode step carries the frozen encoder output, the others the
    frame embeddings, with the reference's shapes and dtypes."""
    cfg, jcfg = get_config(ARCH, smoke=True), jget_config(ARCH, smoke=True)
    mine = M.input_specs(cfg, InputShape("s", 16, 2, kind))
    ref = JM.input_specs(jcfg, JInputShape("s", 16, 2, kind))
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype).split(".")[-1] == str(v.dtype), k
    assert ("enc_out" in mine) == (kind == "decode")


# ---------------------------------------------------------------- decode


@pytest.mark.parametrize("plen", [1, 5])
@pytest.mark.parametrize("enc_key", ["enc_out", "enc_embeds"])
def test_prefill_and_decode_equal_reference_forward(plen, enc_key):
    """`plen` prompt tokens prefilled into a fresh cache (plen 1: token
    by token from the start), then one token a step to 8: every step's
    logits are the reference ``forward``'s at those positions. The
    prefill's batch carries the encoder output or the frame embeddings
    (the encoder then runs inside the step); the steps carry enc_out."""
    cfg, jcfg, jp, tp = _setup()
    toks, emb = _inputs(cfg)
    want = _jforward()
    enc_out = T.run_encoder(cfg, tp, torch.from_numpy(emb))
    enc = {"enc_out": enc_out} if enc_key == "enc_out" \
        else {"enc_embeds": torch.from_numpy(emb)}
    cache = T.init_cache(cfg, tp, 2, 16)
    tl, cache, _ = T.decode_step(
        cfg, tp, {"tokens": torch.from_numpy(toks[:, :plen]), **enc}, cache,
        0)
    _close(tl, want[:, :plen], "prefill into the cache vs forward")
    for i in range(plen, toks.shape[1]):
        tl, cache, _ = T.decode_step(
            cfg, tp, {"tokens": torch.from_numpy(toks[:, i:i + 1]),
                      "enc_out": enc_out}, cache, i)
        _close(tl[:, 0], want[:, i], f"decode step at position {i}")


def test_batch_api_greedy_tokens_equal_a_forward_oracle():
    """``ServingEngine.prefill`` (with the frame embeddings) then
    ``decode`` (with the encoder output): the greedy tokens of an oracle
    that reruns the reference's ``forward`` on the growing sequence."""
    cfg, jcfg, jp, tp = _setup()
    toks, emb = _inputs(cfg, s=6, seed=4)
    steps = 4
    seq = jnp.asarray(toks)
    oracle = []
    for _ in range(steps + 1):
        jl, _ = JT.forward(jcfg, jp, {"tokens": seq,
                                      "enc_embeds": jnp.asarray(emb)})
        nxt = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)
        oracle.append(np.asarray(nxt))
        seq = jnp.concatenate([seq, nxt[:, None]], axis=1)
    eng = ServingEngine(cfg, tp, max_len=16)
    first, cache, plen = eng.prefill({"tokens": toks, "enc_embeds": emb})
    assert plen == toks.shape[1]
    out, _, clen = eng.decode(first, cache, plen, steps, extra={
        "enc_out": T.run_encoder(cfg, tp, torch.from_numpy(emb))})
    assert clen == plen + steps
    got = np.concatenate([first.numpy()[:, None], out.numpy()], axis=1)
    np.testing.assert_array_equal(got, np.stack(oracle, axis=1))


# ------------------------------------------------- the reference's faults


def test_reference_decode_step_ignores_enc_out():
    """The reference's ``decode_step`` logits do not move when the
    encoder output is dropped (no cross-attention in its decode); the
    port's move by more than 0.1."""
    cfg, jcfg, jp, tp = _setup()
    toks, emb = _inputs(cfg)
    je = JT._run_encoder(jcfg, jp, {"enc_embeds": jnp.asarray(emb)})
    jc = JT.init_cache(jcfg, jp, 2, 16)
    zero = jnp.asarray(0, jnp.int32)
    with_enc, _, _ = JT.decode_step(
        jcfg, jp, {"tokens": jnp.asarray(toks), "enc_out": je}, jc, zero)
    without, _, _ = JT.decode_step(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   jc, zero)
    np.testing.assert_array_equal(np.asarray(with_enc), np.asarray(without))
    te = torch.from_numpy(np.array(je))
    a, _, _ = T.decode_step(cfg, tp, {"tokens": torch.from_numpy(toks),
                                      "enc_out": te},
                            T.init_cache(cfg, tp, 2, 16), 0)
    b, _, _ = T.decode_step(cfg, tp, {"tokens": torch.from_numpy(toks),
                                      "enc_out": torch.zeros_like(te)},
                            T.init_cache(cfg, tp, 2, 16), 0)
    assert float((a - b).abs().max()) > 0.1


def test_reference_prefill_into_cache_strays_from_its_forward():
    """Batch 2, an 8-token prompt, seeded frame embeddings: the
    reference's prefill into a fresh cache differs from its own
    ``forward`` by more than 1 (no cross-attention, and every token at
    the sinusoid of position 0); the port's equals that ``forward``."""
    cfg, jcfg, jp, tp = _setup()
    toks, emb = _inputs(cfg)
    je = JT._run_encoder(jcfg, jp, {"enc_embeds": jnp.asarray(emb)})
    jpl, _, _ = JT.decode_step(
        jcfg, jp, {"tokens": jnp.asarray(toks), "enc_out": je},
        JT.init_cache(jcfg, jp, 2, 16), jnp.asarray(0, jnp.int32))
    assert np.abs(np.asarray(jpl) - _jforward()).max() > 1.0
    tl, _, _ = T.decode_step(
        cfg, tp, {"tokens": torch.from_numpy(toks),
                  "enc_out": torch.from_numpy(np.asarray(je))},
        T.init_cache(cfg, tp, 2, 16), 0)
    _close(tl, _jforward(), "the port's prefill into the cache vs forward")


# ---------------------------------------------------------------- refusals


def test_encdec_refusals():
    """Continuous batching (``start``, ``serve``) and paged KV are
    refused as the reference refuses them; forward without frame
    embeddings, a decode step with no encoder input and a per-row
    cache_len raise."""
    cfg, jcfg, jp, tp = _setup()
    toks, emb = _inputs(cfg)
    with pytest.raises(NotImplementedError, match="fixed-batch"):
        JServingEngine(jcfg, jp, max_len=16).start()
    eng = ServingEngine(cfg, tp, max_len=16)
    with pytest.raises(NotImplementedError, match="fixed-batch"):
        eng.start()
    with pytest.raises(NotImplementedError, match="fixed-batch"):
        eng.serve([GenRequest(rid=0, arrival=0.0, prompt=toks[0],
                              max_new_tokens=2)])
    with pytest.raises(ValueError, match="attention-only"):
        ServingEngine(cfg, tp, max_len=16, serving=ServingSpec(kv="paged"))
    with pytest.raises(ValueError, match="attention-only"):
        PagedKVCache(cfg, tp, 2, 16)
    with pytest.raises(ValueError, match="attention-only"):
        T.init_paged_cache(cfg, tp, 8, 4)
    with pytest.raises(ValueError, match="enc_embeds"):
        T.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    cache = T.init_cache(cfg, tp, 2, 16)
    with pytest.raises(ValueError, match="enc_out"):
        T.decode_step(cfg, tp, {"tokens": torch.from_numpy(toks)}, cache, 0)
    with pytest.raises(ValueError, match="int cache_len"):
        T.decode_step(cfg, tp, {"tokens": torch.from_numpy(toks[:, :1]),
                                "enc_embeds": torch.from_numpy(emb)},
                      cache, torch.tensor([3, 4], dtype=torch.int32))


# ---------------------------------------------------------------- gelu


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_dense_ffn_equals_reference(act):
    """``layers.ffn`` (whisper's gelu: the tanh approximation, as
    ``jax.nn.gelu`` computes by default) against the reference's."""
    jp = jax.tree.map(np.asarray, JL.init_ffn(jax.random.PRNGKey(1), 32, 64,
                                              act, jnp.float32))
    x = np.random.default_rng(2).standard_normal((2, 5, 32)) \
        .astype(np.float32)
    _close(L.ffn(from_jax(jp), torch.from_numpy(x), act),
           JL.ffn(jp, jnp.asarray(x), act), act)


@pytest.mark.parametrize("quantized", [False, True])
def test_gelu_expert_dispatch_equals_reference(quantized):
    """The GShard dispatch with gelu experts (``gmm`` up, gelu, ``gmm``
    down), on the reference's bank or its int8 form: the same expert
    loads and drops, allclose outputs, at a capacity factor that drops
    tokens."""
    e, d, f = 8, 16, 32
    ks = jax.random.split(jax.random.PRNGKey(5), 2)
    jp = {"router": JMOE.init_router(ks[0], d, e, jnp.float32),
          "experts": JMOE.init_experts(ks[1], d, f, e, "gelu", jnp.float32)}
    assert sorted(jp["experts"]) == ["w_down", "w_up"]
    if quantized:
        jp = dict(jp, experts=JQ.quantize_expert_bank(jp["experts"]))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    if quantized:   # the port quantizes to the same int8 bank
        mine = Q.quantize_expert_bank(from_jax(jax.tree.map(
            np.asarray, JQ.dequantize_expert_bank(jp["experts"]))))
        for k, v in tp["experts"].items():
            torch.testing.assert_close(mine[k], v, atol=1e-7, rtol=0)
    x = np.random.default_rng(6).standard_normal((2, 12, d)) \
        .astype(np.float32)
    kw = dict(top_k=2, num_experts=e, capacity_factor=1.0, act="gelu")
    jy, jm = JMOE.dispatch_moe(jp, jnp.asarray(x), impl="ref", **kw)
    ty, tm = MOE.dispatch_moe(tp, torch.from_numpy(x), impl="auto", **kw)
    np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                  np.asarray(jm["expert_load"]))
    assert float(tm["dropped"]) == float(jm["dropped"]) > 0
    _close(ty, jy, "y")


def test_gelu_moe_model_forward_equals_reference():
    """mixtral-8x7b's smoke config at act gelu through ``forward``:
    logits, expert loads and drops equal the reference's."""
    cfg, jcfg, jp, tp = _setup("mixtral-8x7b", act="gelu")
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jm = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tm = T.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, "logits")
    np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                  np.asarray(jm["expert_load"]))
    np.testing.assert_array_equal(tm["dropped"].numpy(),
                                  np.asarray(jm["dropped"]))


def test_gelu_slot_plane_keeps_the_reference_limit():
    """The EP slot plane and the expert runtime refuse gelu experts, as
    the reference's runtime does, and say so."""
    cfg, jcfg, jp, tp = _setup("mixtral-8x7b", act="gelu")
    with pytest.raises(NotImplementedError, match="swiglu"):
        JExpertRuntime(jcfg, jp, num_devices=2)
    with pytest.raises(NotImplementedError,
                       match="expert_runtime.py:169"):
        ExpertRuntime(cfg, tp, num_devices=2)
    x = torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(NotImplementedError,
                       match="expert_runtime.py:169"):
        EP.moe_ep_layer(x, None, {}, {}, num_experts=8, top_k=2,
                        slots_per_device=2, capacity_factor=1.0, act="gelu")
