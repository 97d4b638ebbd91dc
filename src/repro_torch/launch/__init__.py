"""Launchers of the port: ``serve`` (continuous batched greedy decode)."""
