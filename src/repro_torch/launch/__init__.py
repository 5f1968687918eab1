"""Drivers: `serve` (the LM decode loop, or error-bounded AQP queries) and
`train` (the LM training loop on the PS³ token data plane); the dry run
(`dryrun` on `mesh`, `specs` and `op_stats`), its `roofline` and the
`perf_probe`."""
