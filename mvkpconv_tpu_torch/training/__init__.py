"""Training-side configuration of the port."""
