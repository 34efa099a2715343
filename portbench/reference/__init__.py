"""The plain PyTorch reference that every run is judged against; it imports
nothing of the program."""
