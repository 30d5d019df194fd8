"""Memory formats of the port (counterpart of ``paddle_tpu/memory``): the
int8 quantizers (row-wise for the int8 KV cache and weights, blockwise for
the int8 activation saves), ``int8_checkpoint``, the selective-remat
save names and anchors, and the batch and remat planner (``planner.py``).
The reference's layout autotuner (``memory/autotune.py``) waits on the
multi-card slice."""
from .int8_ckpt import (INT8_BLOCK, SCALE_EPS, dequantize_blockwise_int8,
                        dequantize_rows_int8, int8_checkpoint,
                        int8_saved_nbytes, quantize_blockwise_int8,
                        quantize_rows_int8)
from .remat import (KERNEL_ANCHORS, anchor, parse_save_names,
                    split_quant_entries)
from .planner import (Candidate, MemoryPlanError, PlanDecision, chip_kind,
                      default_program_key, estimate_stacked_activation_bytes,
                      hbm_budget_bytes, plan_train_step, policy_coverage,
                      throughput_score, zero_hbm_savings)

__all__ = ["SCALE_EPS", "quantize_rows_int8", "dequantize_rows_int8",
           "INT8_BLOCK", "quantize_blockwise_int8",
           "dequantize_blockwise_int8", "int8_saved_nbytes",
           "int8_checkpoint", "KERNEL_ANCHORS", "anchor",
           "parse_save_names", "split_quant_entries",
           "Candidate", "PlanDecision", "MemoryPlanError", "plan_train_step",
           "hbm_budget_bytes", "chip_kind", "throughput_score",
           "policy_coverage", "estimate_stacked_activation_bytes",
           "zero_hbm_savings", "default_program_key"]
