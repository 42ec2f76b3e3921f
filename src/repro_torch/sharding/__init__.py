"""Sharding rules of the port: logical axes, param specs, the blocks each rank holds."""
