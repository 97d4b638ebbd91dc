"""Launchers of the port: ``serve`` (continuous batched greedy decode),
``train`` (the fault-tolerant train loop, on one device or over the ranks
torchrun starts) and ``mesh`` (the production and test meshes)."""
