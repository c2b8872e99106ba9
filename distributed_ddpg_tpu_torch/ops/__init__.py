"""Optimizer, target update, losses, exploration noise and the learner
chunk kernel's wrapper. Importing the package imports no torch: actor
workers import ops.noise and never touch CUDA."""
