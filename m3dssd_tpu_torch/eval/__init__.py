"""KITTI AP11 / AP-R40 evaluation (numpy, with a native C++ engine)."""
