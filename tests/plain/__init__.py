"""Plain references of the port-only architectures, for the CPU tests."""
