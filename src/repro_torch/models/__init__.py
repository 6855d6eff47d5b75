"""models — the LM side-zoo: configuration, transformer layers and the
assembled model (dense family), in PyTorch."""
