"""The jobs that drive the program, one module for each kind of traffic."""
