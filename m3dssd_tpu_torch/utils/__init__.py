"""Helpers: device choice, synthetic config, weight bridge."""
