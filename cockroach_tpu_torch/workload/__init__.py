"""Workload generators (counterpart of cockroach_tpu/workload): the TPC-H
generator and the TPC-H queries the port runs."""
