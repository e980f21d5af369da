"""Plain references of the benchmark, one module per route a configuration names
(its ``"reference"`` key). Each imports torch and numpy only: nothing of the
program, nothing of JAX."""
