"""Small neural-net building blocks (pure functions over param pytrees).

Layouts: NHWC for 2-D convs, NWC for 1-D convs, and all dense weights stored
(in, out) so applications are plain row-major matmuls. Initializers reproduce PyTorch defaults (uniform +-1/sqrt(fan_in)) so
from-scratch training matches the reference's optimization behavior.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax


# ----------------------------------------------------------------------------
# initializers (PyTorch-default equivalents)
# ----------------------------------------------------------------------------

def uniform_init(key, shape, bound, dtype=jnp.float32):
    return jax.random.uniform(key, shape, dtype, minval=-bound, maxval=bound)


def linear_init(key, d_in, d_out, dtype=jnp.float32):
    """nn.Linear default init: U(+-1/sqrt(fan_in)) for weight and bias."""
    kw, kb = jax.random.split(key)
    bound = 1.0 / math.sqrt(d_in)
    return {
        "w": uniform_init(kw, (d_in, d_out), bound, dtype),
        "b": uniform_init(kb, (d_out,), bound, dtype),
    }


def conv_init(key, kh, kw, c_in, c_out, dtype=jnp.float32):
    """nn.Conv2d default init with HWIO layout."""
    kker, kb = jax.random.split(key)
    bound = 1.0 / math.sqrt(c_in * kh * kw)
    return {
        "w": uniform_init(kker, (kh, kw, c_in, c_out), bound, dtype),
        "b": uniform_init(kb, (c_out,), bound, dtype),
    }


def conv1d_init(key, kw, c_in, c_out, dtype=jnp.float32):
    """nn.Conv1d default init with WIO layout."""
    kker, kb = jax.random.split(key)
    bound = 1.0 / math.sqrt(c_in * kw)
    return {
        "w": uniform_init(kker, (kw, c_in, c_out), bound, dtype),
        "b": uniform_init(kb, (c_out,), bound, dtype),
    }


def gru_dir_init(key, d_in, hidden, dtype=jnp.float32):
    """One GRU direction: nn.GRU default init U(+-1/sqrt(H)) on all tensors."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    bound = 1.0 / math.sqrt(hidden)
    return {
        "wi": uniform_init(k1, (d_in, 3 * hidden), bound, dtype),
        "wh": uniform_init(k2, (hidden, 3 * hidden), bound, dtype),
        "bi": uniform_init(k3, (3 * hidden,), bound, dtype),
        "bh": uniform_init(k4, (3 * hidden,), bound, dtype),
    }


def layer_norm_init(dim, dtype=jnp.float32):
    return {"scale": jnp.ones((dim,), dtype), "bias": jnp.zeros((dim,), dtype)}


# ----------------------------------------------------------------------------
# applications
# ----------------------------------------------------------------------------

def dense(x: jnp.ndarray, p: dict) -> jnp.ndarray:
    return jnp.dot(x, p["w"].astype(x.dtype), preferred_element_type=x.dtype) + p[
        "b"
    ].astype(x.dtype)


def layer_norm(x: jnp.ndarray, p: dict, eps: float = 1e-5) -> jnp.ndarray:
    """LayerNorm over the last axis, matching nn.LayerNorm (biased variance)."""
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mu), axis=-1, keepdims=True)
    xn = (x - mu) * lax.rsqrt(var + eps)
    return xn * p["scale"].astype(x.dtype) + p["bias"].astype(x.dtype)


def conv2d_nhwc(x: jnp.ndarray, p: dict, *, padding="SAME", stride=(1, 1)) -> jnp.ndarray:
    """x: (N, H, W, C) — kernel HWIO."""
    y = lax.conv_general_dilated(
        x,
        p["w"].astype(x.dtype),
        window_strides=stride,
        padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=x.dtype,
    )
    return y + p["b"].astype(x.dtype)


def conv1d_nwc(x: jnp.ndarray, p: dict, *, padding="SAME", stride=1) -> jnp.ndarray:
    """x: (N, W, C) — kernel WIO."""
    y = lax.conv_general_dilated(
        x,
        p["w"].astype(x.dtype),
        window_strides=(stride,),
        padding=padding,
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=x.dtype,
    )
    return y + p["b"].astype(x.dtype)


def max_pool_2x2(x: jnp.ndarray) -> jnp.ndarray:
    """2x2/stride-2 max pool on NHWC, floor-mode like nn.MaxPool2d(2)."""
    return lax.reduce_window(
        x,
        -jnp.inf if jnp.issubdtype(x.dtype, jnp.floating) else jnp.iinfo(x.dtype).min,
        lax.max,
        window_dimensions=(1, 2, 2, 1),
        window_strides=(1, 2, 2, 1),
        padding="VALID",
    )


def dropout(x: jnp.ndarray, rate: float, rng, train: bool) -> jnp.ndarray:
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(rng, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0).astype(x.dtype)
