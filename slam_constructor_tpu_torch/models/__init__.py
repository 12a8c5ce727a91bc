"""Engines and presets of the port."""
