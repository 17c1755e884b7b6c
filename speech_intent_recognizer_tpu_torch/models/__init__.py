"""CNN -> BiGRU -> attention intent classifier (PyTorch)."""
