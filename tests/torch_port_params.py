"""Seeded parameter trees for the port's parity tests: the shapes of a
tts_tpu module's params (jax.eval_shape of init, no compute) filled from a
numpy seed, so both packages get the same non-trivial weights fast."""

import jax
import numpy as np
from flax.core import unfreeze


def init_shapes(module, *args, **kwargs):
    key = jax.random.PRNGKey(0)
    return unfreeze(jax.eval_shape(
        lambda: module.init({"params": key, "dropout": key, "noise": key},
                            *args, **kwargs))["params"])


def random_params(shapes, rng):
    """Fan-in scaled kernels and embeddings, scales (LayerNorm, weight norm)
    near 1, small biases and ActNorm terms, orthogonal invertible 1x1 flow
    weights. Nothing is zero, so no zero-initialized block is an identity."""
    out = {}
    for key, leaf in shapes.items():
        if hasattr(leaf, "items"):
            out[key] = random_params(leaf, rng)
            continue
        shape = leaf.shape
        if key == "weight":                       # InvConvNear
            w = np.linalg.qr(rng.standard_normal(shape))[0]
            if np.linalg.det(w) < 0:
                w[:, 0] = -w[:, 0]
            out[key] = w.astype(np.float32)
        elif key in ("kernel", "embedding") or key.startswith("emb_rel"):
            fan_in = int(np.prod(shape[:-1])) if key == "kernel" else shape[-1]
            out[key] = (rng.standard_normal(shape) / np.sqrt(fan_in)
                        ).astype(np.float32)
        elif key == "scale":
            out[key] = (1.0 + 0.1 * rng.standard_normal(shape)
                        ).astype(np.float32)
        else:
            out[key] = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return out


def module_params(module, seed, *args, **kwargs):
    return random_params(init_shapes(module, *args, **kwargs),
                         np.random.default_rng(seed))
