"""Host file readers of the port."""
