"""The eager core of the surface: ``Tensor``, ``Parameter`` and
``apply_op`` (counterpart of ``paddle_tpu/core``)."""
