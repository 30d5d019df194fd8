"""Layers of the Paddle surface (counterpart of ``paddle_tpu/nn/layer``)."""
