"""Decode, NMS and the detector entry points."""
