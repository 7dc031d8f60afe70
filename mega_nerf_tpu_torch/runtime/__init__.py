"""The runners (one model; every cell of a grid), checkpoints, metrics log."""
