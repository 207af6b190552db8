"""Plain PyTorch references of the model families.  They import nothing
of the program: they recompute from the raw edges and the weights the
benchmark made every value the program derives (self loops, edge
weights, attention)."""
