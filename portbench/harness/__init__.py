"""The harness: finds a cell's files by name, makes its weights and inputs
from the seed, drives the program's timed path, reads the trace, and
compares the written images with the reference."""
