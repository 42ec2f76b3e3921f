"""RL rollouts of the port: the paper's benchmark unit (environments and
an MLP policy stepped on the device, collected as Syndeo tasks)."""
