"""Detector modules (NCHW, channels_last)."""

from .attention import NLPM
from .rpn import M3DRPN, bias_background, build

__all__ = ["M3DRPN", "NLPM", "bias_background", "build"]
