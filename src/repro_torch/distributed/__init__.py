"""Multi-device execution: the partition-axis data plane (`dataplane`)."""
