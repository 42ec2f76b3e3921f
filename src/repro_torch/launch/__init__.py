"""Launch helpers of the port: device meshes over the process group."""
