"""Measurement tools for the port (they run on the card)."""
