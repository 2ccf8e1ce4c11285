"""LMS: the memory planner (`planner`, `costmodel`), the activation policy
and its per-layer recompute boundary (`policies`), and the host side of
the swap (`offload`). The executor of a plan is the layer-streaming
decoder (`models/transformer.py`) and the streamed optimizer sweep
(`train/steps.py`)."""
from repro_torch.core.lms.costmodel import CostModel
from repro_torch.core.lms.planner import (MemoryPlan, PlanRequest, SwapSchedule,
                                          TensorClass, check_schedule_invariant,
                                          plan, plan_memory, plan_serve_memory,
                                          plan_to_policy, validate_optimizer,
                                          activation_classes,
                                          kv_cache_bytes_dev, layer_flops_dev)
from repro_torch.core.lms.policies import (build_policy, policy_from_preset, tag,
                                           tagged)
from repro_torch.core.lms import offload

__all__ = ["CostModel", "MemoryPlan", "PlanRequest", "SwapSchedule",
           "TensorClass", "check_schedule_invariant", "plan", "plan_memory",
           "plan_serve_memory", "plan_to_policy", "validate_optimizer",
           "activation_classes", "kv_cache_bytes_dev", "layer_flops_dev",
           "build_policy", "policy_from_preset", "tag", "tagged", "offload"]
