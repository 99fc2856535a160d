"""Models of the port (torch ``nn.Module``s)."""
