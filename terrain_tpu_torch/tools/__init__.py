"""Measurement tools run on the card by hand (not on any main path)."""
