"""Data generators and partitioners (numpy)."""
