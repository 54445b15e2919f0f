"""Per-value reductions over packed histories: plain scatters and the
hand-written CUDA kernel that fuses them."""
