"""Distributed training state of the port (counterpart of
``paddle_tpu/distributed``): so far the single-process checkpoint
package, ``distributed.checkpoint``."""
