"""Low-level helpers (permutations, masked counts) and the GPU swap-cascade kernel."""
