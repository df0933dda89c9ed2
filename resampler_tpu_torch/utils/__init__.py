"""State conversion between numpy and the port."""
