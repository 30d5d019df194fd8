"""How far the port and the JAX package part on one ResNet training step,
and why: prints, for ``resnet18`` and ``resnet50`` at 2 x 3 x 32 x 32 and
64 x 64, with and without damping the residual branches' last batch norms
(``test_torch_vision.resnet_step``), the loss's relative gap and the
largest gradient gap of a leaf's norm between

- the port and the JAX package in f32,
- the port and the JAX package in f64 (JAX under ``jax.enable_x64``),
- the port in f32 and the port in f64.

Where the step is ill-conditioned the first and the third are alike and
the second is small: the f32 gap is rounding, not a fault of either
package. Runs on the CPU in about two minutes:

    python tests/torch_resnet_conditioning.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu import dtypes as jdt  # noqa: E402
from paddle_tpu.nn import initializer as jinit  # noqa: E402
from test_torch_vision import grad_err, resnet_step  # noqa: E402


def _zeros(self, shape, dtype):
    return jnp.asarray(np.zeros(shape, jdt.to_np(dtype)))


def _gaps(a, b):
    """(loss gap, largest gradient gap) between the results ``a`` and
    ``b``, each a function of a :func:`resnet_step` result."""
    la, lb = a("loss"), b("loss")
    return (abs(la - lb) / abs(lb),
            max(grad_err(a("grads")[n], b("grads")[n]) for n in a("grads")))


def main():
    # the JAX layers' initializers as zeros (every weight is seeded after)
    for cls in (jinit.Constant, jinit.Normal, jinit.TruncatedNormal,
                jinit.Uniform, jinit.XavierNormal, jinit.XavierUniform,
                jinit.KaimingNormal, jinit.KaimingUniform):
        cls._init_array = _zeros
    tp.set_device("cpu")
    print("model image damped | f32 port-jax loss grad | f64 port-jax loss "
          "grad | port f32-f64 loss grad")
    for name in ("resnet18", "resnet50"):
        for image in (32, 64):
            for damp in (False, True):
                r32 = resnet_step(name, image, damp)
                with jax.enable_x64(True):
                    r64 = resnet_step(name, image, damp, "float64")

                def side(r, i):
                    def get(key):
                        v = r[key]
                        if key == "loss":
                            return v[i]
                        return {n: p[i] for n, p in v.items()}
                    return get

                rows = (_gaps(side(r32, 0), side(r32, 1)),
                        _gaps(side(r64, 0), side(r64, 1)),
                        _gaps(side(r32, 0), side(r64, 0)))
                print(f"{name} {image} {damp} | " + " | ".join(
                    f"{lg:.3e} {gg:.3e}" for lg, gg in rows), flush=True)


if __name__ == "__main__":
    main()
