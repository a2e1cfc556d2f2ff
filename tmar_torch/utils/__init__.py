"""Utilities of the trainer: timing and profiling, metric logging, the
TensorBoard scalar writer."""

from tmar_torch.utils.logging import MetricLogger
from tmar_torch.utils.profiling import StepTimer, model_flops, trace_profile

__all__ = ["StepTimer", "trace_profile", "model_flops", "MetricLogger"]
