"""Federated training workloads."""
