"""Frame operations: tensor code, plus the hand-written kernels' wrappers."""
