"""The ResNet training step of ``tests/test_torch_vision.py`` in float64,
at 2 x 3 x 32 x 32 and without damping the residual branches' last batch
norms: the size at which the step is too ill-conditioned for two f32
libraries to agree. In float64 the port and the JAX package (under
``jax.enable_x64``) agree within the same bounds, so the f32 gap at this
size is rounding, not a fault in either package's convs or batch-norm
backward. ``python tests/torch_resnet_conditioning.py`` prints the gaps
at both sizes and precisions.
"""
import jax
import pytest

from test_torch_conv_pool import fast_jax_init  # noqa: F401
from test_torch_vision import (_cpu, assert_resnet_step_like_jax,  # noqa: F401
                               resnet_step)
from test_torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_train_step_like_jax_in_float64(name, fast_jax_init):
    with jax.enable_x64(True):
        r = resnet_step(name, 32, damp=False, dtype="float64")
    assert_resnet_step_like_jax(r)
