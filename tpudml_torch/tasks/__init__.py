"""Task entry points of the port (``python -m tpudml_torch.tasks.<task>``)."""
