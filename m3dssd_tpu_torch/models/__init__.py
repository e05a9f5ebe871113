"""Detector modules (NCHW, channels_last)."""

from .rpn import M3DRPN, bias_background, build

__all__ = ["M3DRPN", "bias_background", "build"]
