"""PLY IO, prediction artifacts and the standalone HTML viewer of the port."""
