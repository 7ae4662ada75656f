"""The benchmark's yardstick of work: operation and byte counts of the
hand-written kernels, and the card's published peaks."""
