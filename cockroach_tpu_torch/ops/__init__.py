"""Device compute: expressions, sorting, aggregation and the CUDA kernels
(counterpart of cockroach_tpu/ops)."""
