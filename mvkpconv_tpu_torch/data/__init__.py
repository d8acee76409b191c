"""Host-side data helpers of the port (numpy, and the C++ host ops where
``g++`` builds them): scene synthesis, ScanNet and COLMAP IO, sphere
sampling, feature assembly, augmentation, prefetch, budget calibration."""
