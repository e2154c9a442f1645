"""Elementary ops and the hand-written attention kernels."""
