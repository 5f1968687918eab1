"""Drivers: `serve` (the LM decode loop, or error-bounded AQP queries)."""
