"""Expert Load Predictor — paper §4.1.

Speculative prediction: the gate input of MoE layer `l` is fed to a
*replica* of layer `l+d`'s gate network to estimate layer `l+d`'s expert
load distribution `d` layers ahead. Replicated gates are fine-tuned with
layer awareness: per-layer accuracy is profiled first, and only layers
below the target threshold `h` are fine-tuned (early layers are the
unstable ones — Fig. 6). Predictors share the gate's architecture and
parameter count (Table 2: 1.9-4.2 MB total).

The replica weights live on the model's device as one float32 tensor;
``predict_loads_all`` returns a device tensor, so the control plane's
one device->host copy a serving iteration fetches it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import prng
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import adamw


def _topk_idx(logits, k: int):
    """Indices of the top-k along the last axis; ties lower index first,
    as ``jax.lax.top_k`` (a stable descending sort: ``torch.topk``
    promises no order among equals)."""
    return torch.sort(logits, dim=-1, descending=True, stable=True)[1][..., :k]


# ---------------------------------------------------------------- dataset


def collect_gate_dataset(cfg, params, token_batches, *, extra=None):
    """Run the model over token batches collecting, per MoE layer:
    gate inputs (tokens, D) and router logits (tokens, E).
    Returns dict with 'inputs' (Lm, N, D) and 'logits' (Lm, N, E), host
    float32 arrays."""
    dev = params["embed"].device
    gi, rl = [], []
    with torch.no_grad():
        for tokens in token_batches:
            tokens = torch.as_tensor(tokens, device=dev)
            batch = {"tokens": tokens}
            if extra:
                batch.update(extra)
            m = T.forward(cfg, params, batch, collect=True)[1]
            b, s = tokens.shape
            for out, key in ((gi, "gate_input"), (rl, "router_logits")):
                a = m[key]
                out.append(a.reshape(a.shape[0], b * s, -1).float()
                           .cpu().numpy())
    return {"inputs": np.concatenate(gi, axis=1),
            "logits": np.concatenate(rl, axis=1)}


def split_dataset(ds, train_frac: float = 0.7, seed: int = 0):
    """Paper §5: 7:3 train/test split."""
    n = ds["inputs"].shape[1]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    k = int(train_frac * n)
    tr = {k2: v[:, perm[:k]] for k2, v in ds.items()}
    te = {k2: v[:, perm[k:]] for k2, v in ds.items()}
    return tr, te


# ---------------------------------------------------------------- predictor


@dataclass
class LoadPredictor:
    """Per-MoE-layer gate replicas at a fixed prediction distance d.

    weights: (Lm, D, E) float32 on the model's device — predictor for
    layer l (l >= d) is evaluated on gate inputs of layer l-d. Layers
    l < d have no lookahead source and fall back to the actual loads
    (equivalently d=0).
    """
    distance: int
    weights: torch.Tensor                    # (Lm, D, E)
    finetuned_layers: list = field(default_factory=list)

    @property
    def num_layers(self) -> int:
        return self.weights.shape[0]

    @property
    def param_bytes(self) -> int:
        return int(np.prod(self.weights.shape)) * 4

    def _on(self, a):
        return torch.as_tensor(a, device=self.weights.device)

    def predict_logits(self, layer: int, hidden) -> torch.Tensor:
        """hidden: (N, D) gate inputs of layer `layer - d`."""
        return self._on(hidden).to(self.weights.dtype) @ self.weights[layer]

    def predict_loads(self, layer: int, hidden, top_k: int) -> np.ndarray:
        idx = _topk_idx(self.predict_logits(layer, hidden), top_k)
        e = self.weights.shape[-1]
        return torch.bincount(idx.reshape(-1), minlength=e).cpu().numpy()

    def predict_loads_all(self, gate_inputs, actual_loads, top_k: int,
                          token_mask=None) -> torch.Tensor:
        """Batched prediction for ALL MoE layers in one call.

        gate_inputs: (Lm, N, D) this iteration's gate inputs; layer l's
        predictor (l >= d) reads gate_inputs[l-d]. actual_loads: (Lm, E);
        layers l < d have no lookahead source and fall through to the
        actual loads. `token_mask` (N,) excludes tokens (inactive
        continuous-batching slots) from the predicted histograms.
        Returns a (Lm, E) float32 DEVICE tensor, with no host sync and
        no data-dependent shape — the caller decides when the single
        device->host transfer happens, so the per-layer Python loop of
        the control plane never syncs.
        """
        w = self.weights
        src = torch.roll(self._on(gate_inputs), self.distance, dims=0)
        logits = torch.einsum("lnd,lde->lne", src.to(w.dtype), w)
        idx = _topk_idx(logits, top_k)                  # (Lm, N, k)
        oh = F.one_hot(idx, w.shape[-1]).float()        # (Lm, N, k, E)
        if token_mask is not None:
            oh = oh * self._on(token_mask).float()[None, :, None, None]
        pred = oh.sum(dim=(1, 2))
        layer = torch.arange(w.shape[0], device=w.device)[:, None]
        return torch.where(layer >= self.distance, pred,
                           self._on(actual_loads).float())


def from_gates(cfg, params, distance: int) -> LoadPredictor:
    """Replicate the model's gate networks as predictors (paper §4.1)."""
    stacked = [params["layers"][j]["moe"]["router"]["w_gate"]
               for j, sub in enumerate(T.layer_pattern(cfg))
               if sub.ffn == "moe"]
    # (per-period stacking) -> interleave to global MoE-layer order
    ws = torch.stack(stacked, dim=1)         # (P, mpp, D, E)
    ws = ws.reshape((-1,) + ws.shape[2:])    # (Lm, D, E)
    return LoadPredictor(distance=distance, weights=ws.float())


# ---------------------------------------------------------------- metrics


def topk_overlap_accuracy(pred_logits, true_logits, top_k: int) -> float:
    """Per-token fraction of the true top-k expert set recovered by the
    predictor — the paper's 'expert load prediction accuracy'."""
    pred_logits = torch.as_tensor(pred_logits)
    true_logits = torch.as_tensor(true_logits, device=pred_logits.device)
    e = pred_logits.shape[-1]
    po = F.one_hot(_topk_idx(pred_logits, top_k), e).sum(-2)
    to = F.one_hot(_topk_idx(true_logits, top_k), e).sum(-2)
    frac = torch.minimum(po, to).sum(-1).float() / top_k
    # the mean as the reference's CPU backend computes it: the sum times
    # float32(1 / N) (a division rounds some means differently)
    n = torch.tensor(float(frac.numel()), device=frac.device)
    return float(frac.sum() * torch.reciprocal(n))


def load_correlation(pred_loads: np.ndarray, true_loads: np.ndarray) -> float:
    """Pearson correlation of predicted vs actual load histograms (Fig 12)."""
    p = np.asarray(pred_loads, np.float64).ravel()
    t = np.asarray(true_loads, np.float64).ravel()
    if p.std() == 0 or t.std() == 0:
        return 1.0 if np.allclose(p, t) else 0.0
    return float(np.corrcoef(p, t)[0, 1])


def profile_accuracy(pred: LoadPredictor, ds, top_k: int) -> np.ndarray:
    """Per-layer top-k accuracy at the predictor's distance."""
    d = pred.distance
    accs = np.ones(pred.num_layers)
    for l in range(d, pred.num_layers):
        accs[l] = topk_overlap_accuracy(
            pred.predict_logits(l, ds["inputs"][l - d]),
            ds["logits"][l], top_k)
    # layers < d have no lookahead source; they use same-layer gates
    for l in range(min(d, pred.num_layers)):
        accs[l] = topk_overlap_accuracy(
            pred.predict_logits(l, ds["inputs"][l]), ds["logits"][l], top_k)
    return accs


# ---------------------------------------------------------------- finetune


def finetune(pred: LoadPredictor, train_ds, test_ds, top_k: int, *,
             threshold: float = 0.8, steps: int = 200, lr: float = 3e-3,
             batch_size: int = 1024, seed: int = 0,
             verbose: bool = False) -> LoadPredictor:
    """Layer-aware fine-tuning (paper §4.1): profile per-layer accuracy,
    fine-tune only layers below `threshold` with soft-target cross-entropy
    to the true gate distribution. Layers are trained jointly in one
    batched update (the paper parallelises across layers). Batches are
    drawn as the reference draws them (``prng.split``/``randint`` from
    ``prng.key(seed)``), so both packages train on the same tokens."""
    d = pred.distance
    accs = profile_accuracy(pred, test_ds, top_k)
    needy = [l for l in range(d, pred.num_layers) if accs[l] < threshold]
    if not needy:
        return pred

    dev = pred.weights.device
    w_sel = torch.stack([pred.weights[l] for l in needy])      # (n, D, E)
    x_sel = torch.stack([torch.as_tensor(train_ds["inputs"][l - d],
                                         device=dev)
                         for l in needy]).float()              # (n, N, D)
    y_sel = torch.stack([torch.as_tensor(train_ds["logits"][l], device=dev)
                         for l in needy]).float()              # (n, N, E)
    opt = adamw(lr, weight_decay=0.0, clip_norm=1.0)
    state = opt.init(w_sel)
    n_tok = x_sel.shape[1]
    key = prng.key(seed).to(dev)

    def loss_fn(w, x, y):
        # soft-target CE against the true gate distribution
        logp = torch.log_softmax(torch.einsum("lnd,lde->lne", x, w), -1)
        tgt = torch.softmax(y, -1)
        return -torch.mean(torch.sum(tgt * logp, -1))

    bs = min(batch_size, n_tok)
    for i in range(steps):
        key, k = prng.split(key)
        idx = prng.randint(k, bs, 0, n_tok).long()
        x, y = x_sel[:, idx], y_sel[:, idx]
        w = w_sel.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(w, x, y)
            g, = torch.autograd.grad(loss, w)
        w_sel, state = opt.update(w_sel, g, state)
        if verbose and i % 50 == 0:
            print(f"  finetune step {i}: loss={float(loss):.4f}")

    new_w = pred.weights.clone()
    new_w[needy] = w_sel
    return LoadPredictor(distance=d, weights=new_w,
                         finetuned_layers=list(needy))
