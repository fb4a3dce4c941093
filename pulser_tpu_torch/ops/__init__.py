"""Structured Hamiltonian application and solvers, in PyTorch."""
