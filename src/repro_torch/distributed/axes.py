"""The partition axis's name, shared by every sharding rule of the port.

The reference keeps its model axes (``constrain``, ``set_logical_axes``)
here as well; they serve the LM substrate, which the port has not yet.
"""
from __future__ import annotations

# The offline data plane's partition axis (`distributed/dataplane.py`).
PARTITION_AXIS = "part"
