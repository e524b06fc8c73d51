from .definitions import CheckResult, Membership
from .reference import ReferenceEngine

__all__ = ["CheckResult", "Membership", "ReferenceEngine"]
