from ikflow_tpu_torch.utils.misc import boolean_string, safe_mkdir, set_seed, tensor_stats
from ikflow_tpu_torch.utils.profiling import timing_section, trace_to

__all__ = [
    "boolean_string",
    "safe_mkdir",
    "set_seed",
    "tensor_stats",
    "timing_section",
    "trace_to",
]
