"""Multi-device execution: the partition-axis data plane (`dataplane`),
and the LM's sharding rules (`sharding`), logical-axis constraints
(`axes`) and int8 error-feedback pod mean (`compress`)."""
