"""paddle.cinn, the reference's tensor compiler (counterpart of
``paddle_tpu/cinn/``, where ``compiler.compile`` is ``jax.jit``): here
``torch.compile`` with the port's own backend, which keeps each graph
dynamo captures and runs it (the ``to_static`` backend: aten ops and the
port's kernel ops, no inductor, no generated code)."""
from . import compiler, runtime  # noqa: F401
from . import auto_schedule  # noqa: F401
