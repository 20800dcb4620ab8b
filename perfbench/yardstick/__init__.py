"""Frozen copies of the program's sound arithmetic, kept under the
benchmark so that no later change to the program moves the yardstick:
the H100's published peaks (peaks.py), the least time of the port's own
kernels at given shapes (bounds.py), and the kernel-family classifier of
the device trace (families.py). Each file names where it was copied from;
perfbench/tests/test_perfbench_yardstick.py pins the copied numbers."""
