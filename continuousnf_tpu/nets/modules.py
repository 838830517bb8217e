"""Core functional modules: Dense, Chain, MLP, conditional wrapper.

Design notes:
  * Arrays are batch-major `(..., features)` — the transpose of the
    reference's Julia column-major `(features, batch)` convention — so the
    feature axis is the contiguous one and batched matmuls are
    `(B, d_in) @ (d_in, d_out)`.
  * Weights are stored `(d_in, d_out)`; Lux-style glorot-uniform init
    (matching `Lux.Dense`'s default used throughout the reference README).
  * Modules are hashable static config; all state lives in the params pytree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

Params = Any


class Module:
    """Protocol: `init(key, dtype) -> params`, `apply(params, x) -> y`."""

    #: output feature dimension (used for shape checks where known)
    out_dim: Optional[int] = None

    def init(self, key: jax.Array, dtype=jnp.float32) -> Params:
        raise NotImplementedError

    def apply(self, params: Params, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def __call__(self, params: Params, x: jax.Array) -> jax.Array:
        return self.apply(params, x)


def _glorot_uniform(key: jax.Array, shape: Tuple[int, int], dtype) -> jax.Array:
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype=dtype, minval=-limit, maxval=limit)


@dataclasses.dataclass(frozen=True)
class Dense(Module):
    """Affine layer with optional activation: `act(x @ W + b)`.

    Analog of `Lux.Dense(in => out, act)` as used in the reference README
    (`/root/reference/README.md:43`).
    """

    in_dim: int
    out_dim: int
    activation: Optional[Callable[[jax.Array], jax.Array]] = None
    use_bias: bool = True

    def init(self, key: jax.Array, dtype=jnp.float32) -> Params:
        wkey, _ = jax.random.split(key)
        params = {"w": _glorot_uniform(wkey, (self.in_dim, self.out_dim), dtype)}
        if self.use_bias:
            params["b"] = jnp.zeros((self.out_dim,), dtype)
        return params

    def apply(self, params: Params, x: jax.Array) -> jax.Array:
        y = x @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        if self.activation is not None:
            y = self.activation(y)
        return y

    def __repr__(self) -> str:
        act = getattr(self.activation, "__name__", repr(self.activation))
        parts = [f"{self.in_dim} -> {self.out_dim}"]
        if self.activation is not None:
            parts.append(act)
        if not self.use_bias:
            parts.append("bias=False")
        return f"Dense({', '.join(parts)})"


@dataclasses.dataclass(frozen=True)
class Chain(Module):
    """Sequential composition (analog of `Lux.Chain`)."""

    layers: Tuple[Module, ...]

    def __post_init__(self):
        if not isinstance(self.layers, tuple):
            object.__setattr__(self, "layers", tuple(self.layers))
        last = self.layers[-1] if self.layers else None
        object.__setattr__(self, "out_dim", getattr(last, "out_dim", None))

    def init(self, key: jax.Array, dtype=jnp.float32) -> Params:
        keys = jax.random.split(key, len(self.layers))
        return tuple(layer.init(k, dtype) for layer, k in zip(self.layers, keys))

    def apply(self, params: Params, x: jax.Array) -> jax.Array:
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x

    def __repr__(self) -> str:
        return f"Chain({', '.join(repr(l) for l in self.layers)})"


def MLP(
    dims: Tuple[int, ...],
    activation: Callable[[jax.Array], jax.Array] = jnp.tanh,
    final_activation: Optional[Callable[[jax.Array], jax.Array]] = jnp.tanh,
) -> Chain:
    """Convenience constructor for the tanh MLPs the reference uses everywhere
    (e.g. `Chain(Dense(16=>48,tanh), Dense(48=>16,tanh))` in
    `/root/reference/test/regression_tests.jl:7`).

    `dims = (in, hidden..., out)`; every layer gets `activation` except the
    last, which gets `final_activation` (default also tanh, matching the
    reference's nets which put tanh on the output layer too).
    """
    layers = []
    for i in range(len(dims) - 1):
        act = activation if i < len(dims) - 2 else final_activation
        layers.append(Dense(dims[i], dims[i + 1], act))
    return Chain(tuple(layers))


@dataclasses.dataclass(frozen=True)
class CondLayer(Module):
    """Static conditional wrapper module: concatenates a *fixed* conditioning
    block onto the input before applying the wrapped net.

    Parity surface for the reference's `CondLayer`
    (`/root/reference/src/layers/cond_layer.jl:1-9`).  In traced code prefer
    :func:`CondWrap`, which closes over traced `ys` without storing arrays in
    a static dataclass.
    """

    nn: Module
    n_cond: int

    def __post_init__(self):
        object.__setattr__(self, "out_dim", getattr(self.nn, "out_dim", None))

    def init(self, key: jax.Array, dtype=jnp.float32) -> Params:
        return self.nn.init(key, dtype)

    def apply_with_cond(self, params: Params, x: jax.Array, ys: jax.Array) -> jax.Array:
        return CondWrap(self.nn, ys)(params, x)

    def apply(self, params: Params, x: jax.Array) -> jax.Array:
        raise TypeError("CondLayer requires conditioning; use apply_with_cond(params, x, ys)")


def CondWrap(nn: Module, ys: jax.Array) -> Callable[[Params, jax.Array], jax.Array]:
    """Close a module over traced conditioning values.

    Returns `f(params, z) = nn(params, concat([z, ys], -1))`, broadcasting
    `ys` over leading batch axes of `z` — the functional equivalent of the
    reference constructing `CondLayer(nn, ys)` per ODE problem
    (`/root/reference/src/base_icnf.jl:257`).
    """

    def apply(params: Params, z: jax.Array) -> jax.Array:
        ys_b = jnp.broadcast_to(ys, (*z.shape[:-1], ys.shape[-1]))
        return nn.apply(params, jnp.concatenate([z, ys_b], axis=-1))

    return apply


__all__ = ["Module", "Dense", "Chain", "MLP", "CondLayer", "CondWrap", "Params"]
