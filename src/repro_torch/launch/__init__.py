"""Launchers of the port: ``serve`` (continuous batched greedy decode) and
``train`` (the fault-tolerant train loop on one device)."""
