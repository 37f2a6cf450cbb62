"""Logical partitions and the policy that resolves them to mesh axes
(mirrors ``repro/sharding``)."""

from .policy import Policy  # noqa: F401
from .spec import Partitioned, Replicated  # noqa: F401
