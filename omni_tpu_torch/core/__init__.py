"""Framework-free host code the port keeps its own copy of."""
