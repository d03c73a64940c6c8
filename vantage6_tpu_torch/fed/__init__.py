"""Federated aggregation over the station axis."""
