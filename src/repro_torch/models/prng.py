"""Threefry-2x32 counter-based random numbers in torch integer ops, bit
for bit those of the reference's ``jax.random`` calls under
``jax_default_prng_impl="threefry2x32"`` with ``jax_threefry_partitionable``
on (the default of the jax the reference pins):

  key(seed)          jax.random.PRNGKey(seed)      -> (..., 2)
  fold_in(key, n)    jax.random.fold_in(key, n)    -> (..., 2)
  split(key, num)    jax.random.split(key, num)    -> (..., num, 2)
  random_bits(key, n)  32-bit bits of shape (n,) per key -> (..., n)
  randint(key, n, minval, maxval)  jax.random.randint, int32 -> (..., n)
  uniform(key, n, minval, maxval)  jax.random.uniform, float32
  gumbel(key, n)     jax.random.gumbel, mode "low": -log(-log(U(tiny, 1)))
  log(x)             the reference CPU backend's float32 log

A key is an int64 tensor whose last axis holds the two 32-bit words;
every leading axis is a batch axis (one key per row), so a call makes
the same launches whatever the number of rows. Words are held in int64
and masked to 32 bits where a rotation needs them exact; no value leaves
the device.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = 1.1754943508222875e-38     # float32's smallest normal number
# the Cephes float32 log polynomial (Eigen's plog), as XLA's CPU backend
# emits it, its constants rounded to float32
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2, _SQRT_HALF = (float(np.float32(c)) for c in (
    -2.12194440e-4, 0.693359375, 0.707106781186547524))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the count words (x0, x1) under the
    key words (k0, k1); all int64 holding 32-bit values, broadcast
    together. Returns the two output words, masked to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            # x0 stays unmasked between rounds (it only grows by < 2^32 a
            # round, far inside int64); its low 32 bits are exact, and x1
            # is masked after the xor, before its next rotation
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & MASK
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & MASK
    return x0 & MASK, x1


def key(seed) -> torch.Tensor:
    """``PRNGKey(seed)`` of integer seeds (any shape): the words
    (0, seed mod 2^32) — negative int32 seeds wrap to uint32."""
    seed = torch.as_tensor(seed).to(torch.int64)
    return torch.stack([torch.zeros_like(seed), seed & MASK], dim=-1)


def fold_in(k: torch.Tensor, n) -> torch.Tensor:
    """``fold_in(key, n)``: the hash of the count words (0, n mod 2^32)
    under `k`, one per row."""
    n = torch.as_tensor(n, device=k.device).to(torch.int64) & MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(n), n)
    return torch.stack([y0, y1], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``split(key, num)``: the hashes of the count words (0, i) for
    i < num under `k` (partitionable layout), so ``split(k)[..., i, :]``
    equals ``fold_in(k, i)``."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random bits of shape (n,) for each key (partitionable
    layout: the counts are the 64-bit iota 0..n-1, split into words, and
    the output word is the xor of the hash's two words)."""
    lo = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(k: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval): the top 23 bits of each word
    as the mantissa of a float in [1, 2), minus 1, scaled and shifted,
    then clamped below at minval."""
    bits = (random_bits(k, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds as float32 values, applied as scalars (no host copy)
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return (floats * span + float(lo)).clamp_min(float(lo))


def _mul32(a, b):
    """(a * b) mod 2^32 of 32-bit values held in int64, with no product
    past 2^48 (b in 16-bit halves)."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK


def randint(k: torch.Tensor, n: int, minval: int, maxval: int) -> torch.Tensor:
    """int32 integers in [minval, maxval) of shape (n,) per key, as
    ``jax.random.randint``: two words a draw from ``split(k)``, combined
    modulo the span through ``(2^16 mod span)^2 mod span`` in uint32
    arithmetic, where the square wraps (a span of 0 or less returns
    minval)."""
    lo, hi = int(minval), int(maxval)
    span = (hi - lo) & MASK if hi > lo else 1
    ks = split(k)
    higher = random_bits(ks[..., 0, :], n)
    lower = random_bits(ks[..., 1, :], n)
    mult = ((((1 << 16) % span) ** 2) & MASK) % span
    off = (_mul32(higher % span, mult) + lower % span) & MASK
    return ((off % span) + lo).to(torch.int32)


def _fma(a, b, c):
    """float32 a*b+c rounded once: the product is exact in float64, and
    the sum rounds to float64 and then to float32."""
    return (a.double() * b + c).float()


def log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 values, bit for bit the
    reference's on the CPU: split x into a mantissa m in [sqrt(1/2),
    sqrt(2)) and an exponent e, evaluate the Cephes polynomial of m - 1
    with fused multiply-adds where XLA fuses them, add e * ln 2 in two
    parts. (``torch.log`` rounds some elements differently.)"""
    bits = x.clamp_min(_TINY).view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    e = (1.0 + ((bits >> 23) - 127).float()) - small.float()
    m = (m - 1.0) + torch.where(small, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    md = m.double()
    y = _fma(_fma(md, _LOG_P[0], _LOG_P[1]), md, _LOG_P[2])
    y1 = _fma(_fma(md, _LOG_P[3], _LOG_P[4]), md, _LOG_P[5])
    y2 = _fma(_fma(md, _LOG_P[6], _LOG_P[7]), md, _LOG_P[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    return ((m - 0.5 * x2) + y) + _LOG_Q2 * e


def gumbel(k: torch.Tensor, n: int) -> torch.Tensor:
    """float32 standard Gumbel noise of shape (n,) per key, the "low"
    dynamic-range mode: -log(-log(U)) with U uniform in [tiny, 1)."""
    return -log(-log(uniform(k, n, _TINY, 1.0)))
