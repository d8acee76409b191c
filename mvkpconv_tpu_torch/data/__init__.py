"""Host-side data helpers of the port (numpy only): scene synthesis, sphere
sampling, feature assembly, augmentation, prefetch."""
