"""Eval-phase data: KITTI parsing, eval transforms, synthetic scenes."""
