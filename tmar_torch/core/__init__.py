"""Precision policy of the port."""

from tmar_torch.core.precision import BF16_POLICY, DEFAULT_POLICY, Policy

__all__ = ["BF16_POLICY", "DEFAULT_POLICY", "Policy"]
