"""Drivers: `serve` (the LM decode loop, or error-bounded AQP queries) and
`train` (the LM training loop on the PS³ token data plane)."""
