"""The JAX package's random key schedule, replayed bit for bit in torch.

The JAX package draws its sampled tokens with `jax.random` (threefry2x32
keys): generation splits and folds a key per decode segment and step, and
serving folds a key per (request id, token index).  Those streams are a
pure function of the key, so the port computes the same keys and the same
Gumbel noise, and draws the same tokens from the same seed.

This is the schedule of jax 0.9.0 with `jax_threefry_partitionable=True`
(its default there) and the default "low" Gumbel mode:

  * a key is a pair of 32-bit words; `prng_key(s)` is (0, s) for a 32-bit
    seed, as `jax.random.PRNGKey` without x64 makes it;
  * `threefry2x32(key, (c0, c1))` is the 20-round Threefry-2x32 hash;
  * `fold_in(k, d)` is threefry(k, (0, d));
  * `split(k, n)[i]` is threefry(k, (0, i)), both words;
  * 32 random bits at flat index i of a shape are x0 ^ x1 of threefry(k,
    (0, i));
  * `uniform` puts the top 23 bits under the exponent of 1.0, less 1, then
    scales to [tiny, 1); `gumbel` is -log(-log(u)); `categorical` is the
    argmax of logits + gumbel.

Keys are integer tensors of shape [..., 2] holding the words in int64
(torch's uint32 support is partial, the more so on CUDA): every sum and
shift is masked back to 32 bits.  The functions run on the keys' device.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(torch.finfo(torch.float32).tiny)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the key
    words (k0, k1); all int64 tensors of 32-bit values that broadcast
    together, or all Python ints (a host-side key).  Returns the two output
    words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) & MASK32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: the key (0, seed)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`, batched: key [..., 2] and data (an int or an
    integer tensor broadcasting against key[..., 0]) -> keys [..., 2]."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: key [..., 2] -> keys [..., num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., None, 0], key[..., None, 1],
                          torch.zeros_like(i), i)
    return torch.stack((y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits (int64 values in [0, 2^32)) of `shape` for each key of
    key [..., 2]: [..., *shape], the flat index of `shape` the counter."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    y0, y1 = threefry2x32(key[..., 0].reshape(lead), key[..., 1].reshape(lead),
                          torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32 over [minval, maxval): [..., *shape]."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    f32 = torch.float32  # maxval - minval rounded as JAX rounds it, in f32
    scale = float(torch.tensor(maxval, dtype=f32) - torch.tensor(minval, dtype=f32))
    return torch.clamp_min(floats * scale + minval, minval)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.gumbel` in float32 (the "low" mode): [..., *shape]."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def gumbel_scores(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """gumbel noise + logits (f32), whose argmax over the last axis is
    `categorical`'s draw.  A single key [2] draws the noise over the whole
    of `logits` (as JAX does for a batch of rows under one key); keys
    [B, 2] draw each row b of logits [B, V] under its own key (as
    `jax.vmap` over rows does)."""
    return gumbel(key, logits.shape[key.dim() - 1:]) + logits.float()


# XLA's float32 ErfInv: Giles' degree-9 polynomials in w - 2.5 (w < 5)
# and sqrt(w) - 3 (w >= 5), w = -log1p(-x^2).
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv of x (float32), +-inf at +-1: each step of
    the polynomial a fused multiply-add (the product and the sum in
    float64, one rounding to float32)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coef(i):
        c = torch.tensor([_ERFINV_W_LT5[i], _ERFINV_W_GE5[i]], dtype=torch.float32,
                         device=x.device)
        return torch.where(lt, c[0], c[1])

    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT5)):
        p = (coef(i).double() + p.double() * w).float()
    return torch.where(x.abs() == 1, x * torch.inf, p * x)


_NORMAL_LO = -0.9999999403953552  # nextafter(-1, 0) in float32


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.normal` in float32: [..., *shape] for keys [..., 2]."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return torch.tensor(1.4142135623730951, dtype=torch.float32) * erfinv(u)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical` over the last axis (int64 indices); keys as
    in `gumbel_scores`."""
    return torch.argmax(gumbel_scores(key, logits), dim=-1)
