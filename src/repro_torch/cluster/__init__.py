"""Workload traces and run metrics."""
