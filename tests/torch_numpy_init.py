"""The JAX package's initializers, drawing from numpy instead: a jax
initializer compiles for each new shape (about a second a layer on the
CPU), and the port's parity tests carry every weight from the JAX model
into the port anyway. ``install(monkeypatch)`` patches them for a test;
``Constant`` keeps its value, the rest draw N(0, ``std``²)."""
import jax.numpy as jnp
import numpy as np
from paddle_tpu import dtypes as jdt
from paddle_tpu.nn import initializer as jinit


def install(monkeypatch, std=0.2, seed=0):
    rng = np.random.RandomState(seed)

    def draw(self, shape, dtype):
        if isinstance(self, jinit.Constant):
            a = np.full(shape, self.value)
        else:
            a = std * rng.standard_normal(shape)
        return jnp.asarray(a.astype(jdt.to_np(dtype)))

    for cls in (jinit.Constant, jinit.Normal, jinit.TruncatedNormal,
                jinit.Uniform, jinit.XavierNormal, jinit.XavierUniform,
                jinit.KaimingNormal, jinit.KaimingUniform):
        monkeypatch.setattr(cls, "_init_array", draw)
