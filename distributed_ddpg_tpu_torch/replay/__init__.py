"""Replay: the device ring (device.py), its host staging ring and the
n-step accumulator. Importing the package imports no torch: actor workers
import replay.nstep."""
