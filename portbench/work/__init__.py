"""The work a cell's recipe needs, counted from its shapes alone: attention
and GroupNorm shapes with their roofline bounds, the launch plans of the
program's kernels (a cross-check of its counters), FLOPs per image, and the
card's peaks."""
