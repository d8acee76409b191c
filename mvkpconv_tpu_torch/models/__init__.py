"""Models of the port (PyTorch ``nn.Module``s named after the flax scopes)."""
