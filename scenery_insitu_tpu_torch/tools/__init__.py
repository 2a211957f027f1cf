"""Developer tooling that ships with the package (static analysis)."""
