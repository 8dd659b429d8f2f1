"""Image and matching ops: pyramid, FAST, ORB, Hamming matching."""
