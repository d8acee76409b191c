"""PLY output of the port."""
