"""Process utilities (counterpart of cockroach_tpu/util)."""
