"""Test harnesses of the port (counterpart of ``paddle_tpu/testing``):
``testing.chaos``, the training loop's fault injection."""
