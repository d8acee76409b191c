"""Device ops of the port: pyramid, gathers, unprojection and the kernels."""
