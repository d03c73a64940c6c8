"""Shared base layer of the port: the task payload wire format."""
