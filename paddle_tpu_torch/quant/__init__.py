"""Quantized compute (counterpart of ``paddle_tpu/quant``): the scaled
fp8/int8 training GEMMs with delayed scaling, their engagement and parity
gate, and the int8-resident serving weights."""
from .gemm import (DEFAULT_AMAX_HIST, DEFAULT_GATE_TOL, E4M3_MAX, GEMM_SITES,
                   INT8_MAX, PLAN_REASONS, SITE_ALIASES, GemmQuantCtx,
                   amax_hist_len, dtype_max, engaged_quant_sites,
                   fp8_dot_supported, init_amax_state, inline_scaled_gemm,
                   int8_linear, int8_weight_matmul, int8_weights_enabled,
                   last_verdicts, loss_drift_probe, note_gemm_mode,
                   note_plan_engagement, note_step_tokens,
                   quant_compute_enabled, quant_dtype, quant_gate,
                   quant_gate_report, quant_sites_from_policy,
                   quantize_linear_int8, quantize_weight_cols_int8,
                   requested_quant_sites, scaled_gemm, split_quant_entries)

__all__ = ["E4M3_MAX", "INT8_MAX", "GEMM_SITES", "SITE_ALIASES",
           "DEFAULT_AMAX_HIST", "DEFAULT_GATE_TOL", "PLAN_REASONS",
           "fp8_dot_supported", "quant_dtype", "dtype_max", "amax_hist_len",
           "scaled_gemm", "inline_scaled_gemm", "init_amax_state",
           "GemmQuantCtx", "split_quant_entries", "quant_sites_from_policy",
           "requested_quant_sites", "engaged_quant_sites",
           "quant_gate_report", "quant_gate", "quant_compute_enabled",
           "loss_drift_probe", "note_gemm_mode", "note_step_tokens",
           "note_plan_engagement", "last_verdicts",
           "quantize_weight_cols_int8", "int8_weight_matmul",
           "int8_weights_enabled", "quantize_linear_int8", "int8_linear"]
