"""Distributed state of the port (counterpart of
``paddle_tpu/distributed``): so far the single-process checkpoint
package, ``distributed.checkpoint``, and the rendezvous key-value store
``distributed.store.TCPStore`` the serving fleet's hosts meet in."""
