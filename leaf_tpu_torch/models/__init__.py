"""CLIP model code of the port: config registry, layers, towers, weight
interop, image preprocessing and the factory (no eager imports)."""
