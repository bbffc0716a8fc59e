"""Whether what the timed path served is correct: a sample, drawn from
the seed, of the requests the window finished, the longest among them,
recomputed by the float32 reference (``perfbench/reference``) over each
prompt and its served tokens once the window has closed and the
program's state is freed.

The reference follows the program's routing: the experts each MoE layer
sent each token to, as the harness recomputed them from the gate inputs
the engine handed its controller, and whether each assignment was kept,
which the reference works out from those routes and the capacity rule
of the call (the GShard dispatch, or the EP slot plane with the replica
counts of the tables the plans put in force). A batched step's capacity
depends on every row of the batch, which a reference recomputing one
request cannot know otherwise, and a token whose two best experts are
near a tie is routed one way in bfloat16 and the other in float32. The
stages this skips are checked by themselves: the routes must give the
loads the engine reported and the rule the drops it reported, and each
chosen expert's router logit may lie only a little below the
reference's k-th best (``route_gap``).

The numbers compared: the widest gap by which a served token's logit
lies below the reference's best (``widest_gap``), and ``route_gap``."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.core import serve as SV
from perfbench.core import traffic as TR
from perfbench.reference import moe_decoder as REF


def sample(recs: list, seed: int, tokens: int, most: int) -> list:
    """The longest finished request (most served tokens, then the
    lowest id), then others drawn from `seed` until `tokens` served
    tokens or `most` requests."""
    if not recs:
        return []
    recs = sorted(recs, key=lambda r: r.rid)
    longest = max(recs, key=lambda r: (len(r.handle.tokens), -r.rid))
    rest = [r for r in recs if r is not longest]
    rng = np.random.default_rng([seed, 11])
    out, n = [longest], len(longest.handle.tokens)
    for i in rng.permutation(len(rest)):
        if n >= tokens or len(out) >= most:
            break
        out.append(rest[int(i)])
        n += len(rest[int(i)].handle.tokens)
    return out


class Rules:
    """The keep flags of a call's routes under its capacity rule, and
    the consistency of routes and rule with what the engine reported."""

    def __init__(self, arch: REF.Arch, runtime: bool):
        self.arch, self.runtime = arch, runtime
        self._keep: dict[int, torch.Tensor] = {}
        self.calls = self.load_mismatch = self.drop_mismatch = 0

    def keep(self, call) -> torch.Tensor:
        """(Lm, N, k) keep flags of `call`'s routes, on the CPU."""
        got = self._keep.get(id(call))
        if got is not None:
            return got
        a = self.arch
        routes = call.routes.long().cpu()
        keep = torch.stack([
            REF.keep_slots(r, call.slots[li], a.capacity_factor,
                           a.num_experts)
            if self.runtime else
            REF.keep_gshard(r, a.num_experts, a.capacity_factor,
                            SV.dispatch_groups(r.shape[0]))
            for li, r in enumerate(routes)])
        self._check(call, routes, keep)
        self._keep[id(call)] = keep
        return keep

    def _check(self, call, routes, keep) -> None:
        m = call.mask.reshape(-1).cpu().bool()
        e = self.arch.num_experts
        loads = torch.stack([torch.bincount(r[m].reshape(-1), minlength=e)
                             for r in routes]).numpy()
        self.calls += 1
        self.load_mismatch += int(not np.array_equal(loads, call.loads))
        if call.dropped is not None:
            drops = (~keep & m[None, :, None]).sum(dim=(1, 2)).numpy()
            self.drop_mismatch += int(not np.allclose(drops, call.dropped))


def requests(arch: REF.Arch, recs: list, max_len: int, rules: Rules):
    """The sampled requests as the reference takes them, with the
    program's routes and the keep flags of their calls."""
    out = []
    for r in recs:
        row = r.handle.slot
        b = [(c.routes[:, row].long().cpu(), rules.keep(c)[:, row])
             for c in r.decode[:len(r.handle.tokens) - 1]]
        lm, k = r.prefill.routes.shape[0], arch.top_k
        out.append(REF.Request(
            prompt=torch.as_tensor(r.req.prompt).long(),
            served=torch.as_tensor(r.handle.tokens).long(),
            bucket=TR.bucket(len(r.req.prompt), max_len),
            routes_a=r.prefill.routes.long().cpu(),
            keep_a=rules.keep(r.prefill),
            routes_b=torch.stack([x for x, _ in b], 1) if b
            else torch.zeros((lm, 0, k), dtype=torch.long),
            keep_b=torch.stack([y for _, y in b], 1) if b
            else torch.zeros((lm, 0, k), dtype=torch.bool)))
    return out


def _real(req: REF.Request, t):
    """Positions of `t` (L, bucket, ...) that are prompt tokens, then
    served ones: (L, P + n - 1, ...)."""
    p = int(req.prompt.shape[0])
    return torch.cat([t[0][:, :p], t[1]], dim=1)


def compare(arch: REF.Arch, weights: dict, reqs: list,
            prec: REF.Precision = REF.FP32) -> dict:
    """The reference's readings. With the float32 reference (`prec`
    FP32) of the program: the widest gap of its served tokens and the
    route gap of its routes. With a lowered `prec` (the control): the
    same of the tokens that precision puts first and of its own
    routes."""
    worst, rworst, n, same = 0.0, 0.0, 0, 0
    for r in reqs:
        ref = REF.served_logits(arch, weights, r)
        if prec is REF.FP32:
            tok = r.served
            routes = _real(r, (r.routes_a, r.routes_b))
        else:
            low = REF.served_logits(arch, weights, r, prec)
            tok = low["logits"].argmax(-1)
            routes = low["own_routes"]
        g = REF.gaps(ref["logits"], tok)
        rg = REF.route_shortfall(ref["router_logits"], routes)
        worst = max(worst, float(g.max()))
        rworst = max(rworst, float(rg.max()))
        n += int(g.numel())
        same += int((g == 0).sum())
        del ref
    return {"widest_gap": worst, "route_gap": rworst, "tokens": n,
            "first_choice": same / max(n, 1)}
