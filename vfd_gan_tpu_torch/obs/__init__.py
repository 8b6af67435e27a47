"""Run directories, TensorBoard summaries and profiler traces."""
