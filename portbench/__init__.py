"""The port's benchmark (see BENCHMARK.json at the root of the repository)."""
