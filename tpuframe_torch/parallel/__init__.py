"""Data-parallel training: the world and the train/eval steps."""
