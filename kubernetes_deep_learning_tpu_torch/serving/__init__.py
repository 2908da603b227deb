"""HTTP serving front of the port."""
