"""Serving beyond one plain engine (counterpart of
``paddle_tpu/inference/fleet``; its router, supervisor, transport and soak
harness are not ported yet): speculative decoding's draft runner and the
disaggregated prefill/decode pair."""
from .disagg import DisaggregatedEngine
from .spec_decode import DraftRunner

__all__ = ["DisaggregatedEngine", "DraftRunner"]
