"""Compiler (copied from the JAX package), torch reference and ACK."""
