"""Neural building blocks for VAE / subspace models.

Reference parity: ``beer/nnet/`` — MLP builders and ``ProbabilisticLayer``
output heads (NormalDiagonalCovarianceLayer, BernoulliLayer) — rebuilt in
plain JAX.  Distribution heads return *parameter pytrees*; sampling /
log-likelihood / entropy are pure functions of those parameters, so the
whole VAE step jits as one program.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

LOG_2PI = math.log(2.0 * math.pi)

ACTIVATIONS = {"tanh": jnp.tanh, "relu": jax.nn.relu, "gelu": jax.nn.gelu,
               "sigmoid": jax.nn.sigmoid}


def param_key(key, path):
    """The key of the parameter at ``path`` (module names, then the
    parameter's ordinal within its module): SHA-1 of the path folded
    into ``key``.  Every parameter gets its own stream, and a seed gives
    the same initial values as the flax.linen modules these replace."""
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


class Module:
    """A network definition: a frozen, hashable dataclass (it is static
    metadata of the models that hold it) whose parameters live in a
    separate pytree.  ``init(key, x)`` builds float32 parameters for
    inputs shaped like ``x``; ``apply(params, x)`` runs the network."""

    def init(self, key, x, path=()):
        raise NotImplementedError

    def apply(self, params, x):
        raise NotImplementedError


def dense_init(key, path, n_in: int, n_out: int):
    """Affine layer parameters: LeCun-normal kernel, zero bias."""
    init = jax.nn.initializers.lecun_normal()
    return {
        "kernel": init(param_key(key, path + (1,)), (n_in, n_out), jnp.float32),
        "bias": jnp.zeros((n_out,), jnp.float32),
    }


def dense(params, x):
    return x @ params["kernel"] + params["bias"]


@dataclasses.dataclass(frozen=True)
class MLP(Module):
    """Plain MLP trunk: ``hidden`` sizes with ``activation`` (a name in
    ``ACTIVATIONS``) between."""

    hidden: Sequence[int]
    activation: str = "tanh"

    def init(self, key, x, path=()):
        sizes = (x.shape[-1],) + tuple(self.hidden)
        return [dense_init(key, path + (f"Dense_{i}",), a, b)
                for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))]

    def apply(self, params, x):
        for layer in params:
            x = ACTIVATIONS[self.activation](dense(layer, x))
        return x


@dataclasses.dataclass(frozen=True)
class ResMLP(Module):
    """Residual MLP trunk (reference ``beer/nnet`` residual builders).

    Projects to ``hidden[0]`` then applies one pre-activation residual
    block per entry of ``hidden`` (all entries must match — residual
    adds require equal widths).
    """

    hidden: Sequence[int]
    activation: str = "tanh"

    def init(self, key, x, path=()):
        width = self.hidden[0]
        if any(size != width for size in self.hidden):
            raise ValueError("ResMLP needs constant hidden widths")
        return {
            "proj": dense_init(key, path + ("Dense_0",), x.shape[-1], width),
            "blocks": [dense_init(key, path + (f"Dense_{i + 1}",), width, width)
                       for i in range(len(self.hidden))],
        }

    def apply(self, params, x):
        act = ACTIVATIONS[self.activation]
        h = dense(params["proj"], x)
        for block in params["blocks"]:
            h = h + dense(block, act(h))
        return act(h)


@dataclasses.dataclass(frozen=True)
class NormalDiagLayer(Module):
    """Probabilistic head: diagonal Normal (mean, log-variance)."""

    dim: int

    def init(self, key, h, path=()):
        n = h.shape[-1]
        return {"mean": dense_init(key, path + ("Dense_0",), n, self.dim),
                "logvar": dense_init(key, path + ("Dense_1",), n, self.dim)}

    def apply(self, params, h):
        logvar = dense(params["logvar"], h)
        return {"mean": dense(params["mean"], h),
                "logvar": jnp.clip(logvar, -10.0, 10.0)}


@dataclasses.dataclass(frozen=True)
class NormalIsoLayer(Module):
    """Probabilistic head: isotropic Normal (mean vector, scalar logvar),
    broadcast to the diagonal layout so the pure functions below apply."""

    dim: int

    def init(self, key, h, path=()):
        n = h.shape[-1]
        return {"mean": dense_init(key, path + ("Dense_0",), n, self.dim),
                "logvar": dense_init(key, path + ("Dense_1",), n, 1)}

    def apply(self, params, h):
        mean = dense(params["mean"], h)
        logvar = jnp.clip(dense(params["logvar"], h), -10.0, 10.0)
        return {"mean": mean, "logvar": jnp.broadcast_to(logvar, mean.shape)}


@dataclasses.dataclass(frozen=True)
class BernoulliLayer(Module):
    """Probabilistic head: independent Bernoullis (logits)."""

    dim: int

    def init(self, key, h, path=()):
        return {"logits": dense_init(
            key, path + ("Dense_0",), h.shape[-1], self.dim)}

    def apply(self, params, h):
        return {"logits": dense(params["logits"], h)}


def child_names(layers):
    """``<Class>_<n>`` per layer, counting each class separately."""
    seen = {}
    for layer in layers:
        cls = type(layer).__name__
        seen[cls] = seen.get(cls, -1) + 1
        yield f"{cls}_{seen[cls]}"


@dataclasses.dataclass(frozen=True)
class Sequential(Module):
    """Modules applied in order (e.g. a trunk then a head)."""

    layers: Tuple[Module, ...]

    def init(self, key, x, path=()):
        params = []
        for layer, name in zip(self.layers, child_names(self.layers)):
            p = layer.init(key, x, path + (name,))
            x = layer.apply(p, x)
            params.append(p)
        return params

    def apply(self, params, x):
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x


# ----------------------------------------------------------------------
# Distribution functions over head outputs (pure)
# ----------------------------------------------------------------------
def normal_rsample(params, key, nsamples: int = 1):
    """Reparameterized samples, (nsamples, ..., dim)."""
    mean, logvar = params["mean"], params["logvar"]
    eps = jax.random.normal(key, (nsamples,) + mean.shape, mean.dtype)
    return mean[None] + jnp.exp(0.5 * logvar)[None] * eps


def normal_log_likelihood(params, x):
    """log N(x | mean, diag(exp(logvar))) summed over the last axis."""
    mean, logvar = params["mean"], params["logvar"]
    return -0.5 * (
        ((x - mean) ** 2) * jnp.exp(-logvar) + logvar + LOG_2PI
    ).sum(-1)


def normal_entropy(params):
    """Entropy of the diagonal Normal, summed over the last axis."""
    logvar = params["logvar"]
    return 0.5 * (logvar + 1.0 + LOG_2PI).sum(-1)


def bernoulli_log_likelihood(params, x):
    logits = params["logits"]
    return -(jnp.maximum(logits, 0) - logits * x
             + jnp.log1p(jnp.exp(-jnp.abs(logits)))).sum(-1)


# ----------------------------------------------------------------------
# Config-string builders (reference: beer/nnet nets built from strings)
# ----------------------------------------------------------------------
_HEADS = {"normal": "NormalDiagLayer", "normal_iso": "NormalIsoLayer",
          "bernoulli": "BernoulliLayer"}


def build_trunk(spec: str) -> Module:
    """Build an MLP/ResMLP trunk from a config string.

    Format: ``"mlp:128,128[:tanh]"`` or ``"resmlp:256x3[:relu]"``
    (``WxN`` = N residual blocks of width W) — the reference builds its
    encoder/decoder nets from strings in the recipe YAML the same way.
    """
    parts = spec.split(":")
    kind = parts[0].lower()
    act = parts[2].lower() if len(parts) > 2 else "tanh"
    if act not in ACTIVATIONS:
        raise KeyError(act)
    sizes_str = parts[1]
    if "x" in sizes_str:
        w, n = sizes_str.split("x")
        sizes = (int(w),) * int(n)
    else:
        sizes = tuple(int(s) for s in sizes_str.split(","))
    if kind == "mlp":
        return MLP(sizes, act)
    if kind == "resmlp":
        return ResMLP(sizes, act)
    raise ValueError(f"unknown trunk kind: {kind!r} (mlp | resmlp)")


def build_head(spec: str, dim: int) -> Module:
    """Build a probabilistic head: ``"normal" | "normal_iso" | "bernoulli"``."""
    try:
        cls_name = _HEADS[spec.lower()]
    except KeyError:
        raise ValueError(
            f"unknown head: {spec!r} ({' | '.join(_HEADS)})"
        ) from None
    return globals()[cls_name](dim)
