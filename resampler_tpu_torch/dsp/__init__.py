"""Filter design (NumPy only)."""
